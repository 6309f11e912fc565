"""Read sessions: handles, options, lifecycle state (paper §III-A)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.buffers import BufferReaderSet, NetworkModel, ReaderOptions
from repro_torch.core.metrics import SessionMetrics
from repro_torch.io.layout import StripePlan
from repro_torch.io.posix import PosixFile


def _later(option: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not carried by this port yet: it comes with the "
        f"{slice_name} slice (ROADMAP.md, Queue A)")


@dataclass
class FileOptions:
    """Paper: ``Ck::IO::Options`` — ``numReaders`` is the headline knob.

    The port carries the default thread backend. The remaining fields keep
    the reference's names so that configurations read the same, but a
    value other than the default raises ``NotImplementedError`` naming the
    slice that brings it."""

    num_readers: Optional[int] = None       # None → sized from the window
    splinter_bytes: int = 8 * 1024 * 1024
    # Reader backend: only "thread" (helper I/O threads in this process).
    backend: str = "thread"
    # Dynamic splinter sizing: when True, each new session's splinter size is
    # chosen by the Director's SplinterSizer from observed per-reader
    # throughput and steal pressure (core/autotune.py); ``splinter_bytes``
    # then only seeds the first session (no observations yet).
    adaptive_splinters: bool = False
    work_stealing: bool = True
    max_io_threads: int = 64
    placement: str = "node_spread"          # see core/placement.py
    network: Optional[NetworkModel] = None
    delay_model: object = None              # test hook, forwarded to readers
    piece_timing_every: int = 0             # 0 = delivery timing off (hot path)
    topology: Optional[object] = None
    numa_pin: bool = False
    # Zero-fill the arena up front (legacy seed path).
    prefault_arena: bool = False
    # Fault-injection hook for PosixFile.pread_into (short reads / OSErrors).
    io_fault: object = None
    # Hooks of reader worker processes and their event rings (a crash, a
    # torn slot): they act only in the process backend, which the port
    # does not carry yet, so setting either raises.
    worker_fault: object = None
    ring_fault: object = None
    # A seeded core.faults.FaultPlan, expanded into io_fault and
    # delay_model (a hook set explicitly wins). Its worker and ring hooks
    # act only in reader worker processes: on the thread backend they do
    # not act, as in the reference.
    fault_plan: Optional[object] = None
    # -- cold-cache read engine (io/submit.py) -------------------------------
    # Open the file(s) O_DIRECT: reads bypass the page cache and DMA
    # straight into the arena. Requires block-aligned session offset, arena
    # and (for FileSets) shard data regions — violations raise
    # io.posix.DirectIOError at open/start, never silently fall back;
    # sub-block tails go through the buffered fd, counted in
    # RecoveryMetrics.direct_tail_reads.
    direct_io: bool = False
    # In-flight reads per reader: 0/1 = the blocking per-splinter loop;
    # >= 2 = depth-managed async submission through io/submit.py.
    queue_depth: int = 0
    # WILLNEED window (bytes) advised ahead of the submission frontier
    # (buffered files only — O_DIRECT bypasses the cache readahead).
    readahead_bytes: int = 0
    # Submission backend: "auto" (io_uring when the kernel/sandbox allows,
    # else the preadv worker pool), or force "io_uring"/"threads".
    submit_mode: str = "auto"
    # When True, each session's (queue_depth, readahead_bytes) is chosen by
    # the Director's QueueTuner from observed throughput; the explicit
    # fields then only seed the first session.
    adaptive_queue: bool = False

    def reader_options(self) -> ReaderOptions:
        if self.backend == "process":
            raise _later("backend='process'", "process backend and service")
        if self.backend != "thread":
            raise ValueError(
                f"unknown reader backend {self.backend!r} "
                f"(expected 'thread' or 'process')")
        if self.topology is not None or self.numa_pin:
            raise _later("topology / numa_pin", "NUMA")
        if self.submit_mode not in ("auto", "io_uring", "threads"):
            raise ValueError(
                f"unknown submit mode {self.submit_mode!r} "
                f"(expected 'auto', 'io_uring' or 'threads')")
        if self.queue_depth < 0:
            raise ValueError(
                f"queue_depth must be >= 0, got {self.queue_depth}")
        if self.readahead_bytes < 0:
            raise ValueError(
                f"readahead_bytes must be >= 0, got {self.readahead_bytes}")
        if self.worker_fault is not None or self.ring_fault is not None:
            raise _later("worker_fault / ring_fault",
                         "process backend and service")
        delay_model = self.delay_model
        io_fault = self.io_fault
        if self.fault_plan is not None:
            delay_model = delay_model or self.fault_plan.delay_model()
            io_fault = io_fault or self.fault_plan.io_fault()
        return ReaderOptions(
            splinter_bytes=self.splinter_bytes,
            work_stealing=self.work_stealing,
            max_io_threads=self.max_io_threads,
            io_fault=io_fault,
            delay_model=delay_model,  # type: ignore[arg-type]
            network=self.network,
            piece_timing_every=self.piece_timing_every,
            prefault_arena=self.prefault_arena,
            direct_io=self.direct_io,
            queue_depth=self.queue_depth,
            readahead_bytes=self.readahead_bytes,
            submit_mode=self.submit_mode,
        )


@dataclass
class FileHandle:
    """Returned by ``CkIO.open`` / ``CkIO.open_fileset`` (paper:
    ``Ck::IO::File``). ``posix`` is a ``PosixFile``, or the
    byte-space-compatible ``io.posix.ShardedFile`` for FileSet opens
    (``fileset`` then carries the manifest; offsets are global data
    bytes)."""

    id: int
    path: str
    posix: PosixFile                    # or io.posix.ShardedFile (duck-typed)
    opts: FileOptions
    fileset: Optional[object] = None    # data.fileset.FileSet when sharded

    @property
    def size(self) -> int:
        return self.posix.size


@dataclass
class Session:
    """Live read session (paper: ``Ck::IO::Session``)."""

    id: int
    file: FileHandle
    plan: StripePlan
    readers: BufferReaderSet
    opts: FileOptions
    reader_pes: List[int]
    metrics: SessionMetrics = field(default_factory=SessionMetrics)
    closed: bool = False

    @property
    def offset(self) -> int:
        return self.plan.offset

    @property
    def nbytes(self) -> int:
        return self.plan.nbytes

    @property
    def num_readers(self) -> int:
        return self.plan.num_readers

    def contains(self, abs_off: int, nbytes: int) -> bool:
        return abs_off >= self.plan.offset and abs_off + nbytes <= self.plan.end

    @property
    def arrival_order(self):
        """Splinter completion order (see BufferReaderSet.arrival_order)."""
        return self.readers.arrival_order()

    # -- streaming ------------------------------------------------------------
    def subscribe_splinters(self, cb, replay: bool = True) -> int:
        """Per-splinter completion stream (see BufferReaderSet.subscribe)."""
        return self.readers.subscribe(cb, replay=replay)

    def unsubscribe_splinters(self, token: int) -> None:
        self.readers.unsubscribe(token)

    @property
    def splinter_events(self):
        """Recorded completion events so far (arrival order snapshot)."""
        return self.readers.events()
