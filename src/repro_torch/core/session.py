"""Read sessions: handles, options, lifecycle state (paper §III-A)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.buffers import BufferReaderSet, NetworkModel, ReaderOptions
from repro_torch.core.faults import FaultPlan
from repro_torch.core.metrics import SessionMetrics
from repro_torch.core.placement import Topology
from repro_torch.io.layout import StripePlan
from repro_torch.io.posix import PosixFile


@dataclass
class FileOptions:
    """Paper: ``Ck::IO::Options`` — ``numReaders`` is the headline knob."""

    num_readers: Optional[int] = None       # None → autotuned (§VI-A)
    splinter_bytes: int = 8 * 1024 * 1024
    # Reader backend: "thread" (default — helper I/O threads in this
    # process) or "process" (real reader worker processes preadv-ing into a
    # shared-memory arena, splinter events over cross-process rings; see
    # repro_torch/ipc/ and core.buffers.ProcessReaderSet). Zero-copy borrowed
    # views and the splinter stream work identically in both; the process
    # backend has no work stealing and needs picklable delay/fault hooks.
    backend: str = "thread"
    # process backend: cap on worker processes per session (readers are
    # split across workers the way threads split readers).
    max_workers: int = 8
    # process backend: per-worker splinter-event ring capacity (slots). A
    # full ring throttles its worker; it never drops or overwrites events.
    ring_slots: int = 512
    # process backend: picklable crash-injection hook run in the worker
    # before each splinter read ((reader, splinter_index) -> None; e.g.
    # repro_torch.ipc.worker.ExitAfter / RaiseAfter). Test/bench only.
    worker_fault: object = None
    # process backend: seconds to wait for spawned workers to attach
    # (interpreter start + imports — raise on cold/slow-spawn hosts)
    # before the session fails, and the graceful-drain join window
    # before SIGKILL on stop.
    worker_attach_timeout: float = 120.0
    worker_stop_timeout: float = 10.0
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
    # PE -> NUMA-domain model (core/placement.py Topology): turns on
    # domain-coalesced pieces, cross-domain delivery accounting, topology-
    # aware placement policies, and the first-touch arena prefault.
    topology: Optional[Topology] = None
    # Pin reader I/O threads to their stripe's domain CPUs (needs a
    # topology with a CPU map, e.g. Topology.detect; best-effort).
    numa_pin: bool = False
    # Without a topology: zero-fill the arena up front (legacy seed path).
    # With a topology: per-stripe first-touch on the owning reader thread.
    prefault_arena: bool = False
    # -- fault tolerance ------------------------------------------------------
    # process backend: post-gate worker-failure policy — "none" (fail fast,
    # the default), "respawn" (replacement process, same arena, bounded by
    # max_respawns) or "reissue" (supervisor re-reads the unfinished tail).
    # See core.buffers.ProcessReaderSet.
    recovery: str = "none"
    max_respawns: int = 2
    # process backend: no-progress watchdog (seconds; 0 = off) — a hung
    # worker is SIGKILLed and then handled per ``recovery``.
    worker_watchdog_s: float = 0.0
    # Opt-in degraded mode: when backend="process" setup fails (spawn or
    # shm errors), rebuild the session on this backend instead of raising.
    # Only "thread" (or None = no fallback) is valid; warns once per
    # FileOptions and sets RecoveryMetrics.degraded_mode on each session.
    fallback_backend: Optional[str] = None
    # Fault-injection hooks for the lower layers (picklable for the
    # process backend; core/faults.py): io_fault → PosixFile.pread_into,
    # ring_fault → EventRing.publish.
    io_fault: object = None
    ring_fault: object = None
    # A seeded core.faults.FaultPlan: expands into worker_fault /
    # delay_model / io_fault / ring_fault for any hook not set explicitly
    # (explicit hooks win). The deterministic-replay entry point.
    fault_plan: Optional[FaultPlan] = None
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
    # -- persistent reader service (ipc/service.py) --------------------------
    # Routing for process-backend sessions when a ReaderService is attached
    # to the Director: None ("auto", the default) runs on the service and
    # falls back to per-session spawn if admission rejects (ServiceBusy);
    # True pins the session to the service (ServiceBusy surfaces to the
    # caller); False opts out (always per-session spawn). With no service
    # attached, every value behaves like False.
    use_service: Optional[bool] = None
    # Admission fair-share key: sessions from distinct tenants split the
    # service's worker pool fairly ("" = the shared default tenant).
    tenant: str = ""

    def reader_options(self) -> ReaderOptions:
        if self.backend not in ("thread", "process"):
            raise ValueError(
                f"unknown reader backend {self.backend!r} "
                f"(expected 'thread' or 'process')")
        if self.recovery not in ("none", "respawn", "reissue"):
            raise ValueError(
                f"unknown recovery mode {self.recovery!r} "
                f"(expected 'none', 'respawn' or 'reissue')")
        if self.fallback_backend not in (None, "thread"):
            raise ValueError(
                f"unknown fallback backend {self.fallback_backend!r} "
                f"(expected None or 'thread')")
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
        worker_fault = self.worker_fault
        delay_model = self.delay_model
        io_fault = self.io_fault
        ring_fault = self.ring_fault
        if self.fault_plan is not None:
            worker_fault = worker_fault or self.fault_plan.worker_fault()
            delay_model = delay_model or self.fault_plan.delay_model()
            io_fault = io_fault or self.fault_plan.io_fault()
            ring_fault = ring_fault or self.fault_plan.ring_fault()
        return ReaderOptions(
            splinter_bytes=self.splinter_bytes,
            work_stealing=self.work_stealing,
            max_io_threads=self.max_io_threads,
            backend=self.backend,
            max_workers=self.max_workers,
            ring_slots=self.ring_slots,
            worker_fault=worker_fault,
            worker_attach_timeout=self.worker_attach_timeout,
            worker_stop_timeout=self.worker_stop_timeout,
            recovery=self.recovery,
            max_respawns=self.max_respawns,
            worker_watchdog_s=self.worker_watchdog_s,
            io_fault=io_fault,
            ring_fault=ring_fault,
            delay_model=delay_model,  # type: ignore[arg-type]
            network=self.network,
            topology=self.topology,
            numa_pin=self.numa_pin,
            prefault_arena=self.prefault_arena,
            direct_io=self.direct_io,
            queue_depth=self.queue_depth,
            readahead_bytes=self.readahead_bytes,
            submit_mode=self.submit_mode,
        )


@dataclass
class FileHandle:
    """Returned by ``CkIO.open`` / ``CkIO.open_fileset`` (paper:
    ``Ck::IO::File``). ``posix`` is a ``PosixFile`` for single-file opens
    and the byte-space-compatible ``io.posix.ShardedFile`` for FileSet
    opens (``fileset`` then carries the manifest; offsets are global data
    bytes — header pages excluded)."""

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

    @property
    def locality(self):
        """Per-session memory-locality counters (LocalityMetrics)."""
        return self.readers.locality

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
