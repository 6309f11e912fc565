"""Buffer readers: greedy striped prefetch with splintered I/O + work stealing.

This is the paper's *buffer chare* layer (§III-C.4): a configurable set of
reader agents, each owning a disjoint stripe of the session, reading
asynchronously on helper I/O threads so the PEs stay available for
application tasks. Two extensions from the paper's §VI future-work are
implemented as first-class features:

* **Splintered I/O** (§VI-C): stripes are read in ``splinter_bytes`` units and
  client requests are fulfilled as soon as *their* splinters land, rather than
  after the whole stripe.
* **Work stealing / straggler mitigation**: an I/O thread that drains its own
  stripe steals unread splinters from the most-backlogged reader. On a
  1000+-node system slow readers (failing disks, contended OSTs) are the norm;
  stealing bounds session completion at roughly max(splinter) rather than
  max(stripe). A ``delay_model`` hook lets tests/benchmarks inject stragglers
  deterministically.

A ``NetworkModel`` optionally models the buffer→client transfer cost for
cross-"node" deliveries (used by the migration-locality benchmark, paper
Fig. 12); by default delivery is an immediate zero-copy memoryview hand-off.

Two backends: helper I/O threads in this process reading into a pageable
``np.empty`` arena (``BufferReaderSet``), or reader worker processes reading
into a shared-memory arena mapped here too (``ProcessReaderSet``). Either
reads buffered or ``O_DIRECT`` (the arena then sits on the file's block
grid), one blocking read per splinter or ``queue_depth`` reads in flight
through ``io/submit.py``. With a ``Topology`` each stripe is first-touched
(and, with ``numa_pin``, read) on its reader's NUMA domain.
"""
from __future__ import annotations

import heapq
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.metrics import LocalityMetrics, SessionMetrics
from repro_torch.core.placement import Topology
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.io.layout import StripePlan, Splinter, splinters_covering
from repro_torch.io.numa import first_touch, pin_thread_to_cpus
from repro_torch.io.posix import DEFAULT_ALIGN, DirectIOError, PosixFile
from repro_torch.io.submit import AsyncReadEngine, ring_selected
from repro_torch.ipc.ring import (
    PIN_NONE,
    PIN_OK,
    ST_DONE,
    ST_ERROR,
    ST_INIT,
    EventRing,
    RingEvent,
    ring_bytes,
)
from repro_torch.ipc.shm import SharedArena
from repro_torch.ipc.worker import WorkerCrashed, WorkerProcess, WorkerSpec


@dataclass
class ReaderOptions:
    """Tunables for the reader layer (the knobs the paper exposes + §VI)."""

    splinter_bytes: int = 8 * 1024 * 1024
    work_stealing: bool = True
    max_io_threads: int = 64
    # Reader backend: "thread" (helper I/O threads in this process — the
    # default) or "process" (one OS worker process per reader group reading
    # into a shared-memory arena, events over a cross-process ring —
    # ProcessReaderSet below; repro_torch/ipc/).
    backend: str = "thread"
    # process backend: cap on spawned worker processes (readers are split
    # across them the way threads split readers in the thread backend).
    max_workers: int = 8
    # process backend: per-worker event-ring capacity (slots). A full ring
    # throttles its worker (backoff), never drops events.
    ring_slots: int = 512
    # process backend: picklable test hook run before each splinter read in
    # the worker ((reader, splinter_index) -> None; may raise or _exit) —
    # crash-path injection (repro_torch.ipc.worker.ExitAfter / RaiseAfter).
    worker_fault: Optional[object] = None
    # process backend: seconds to wait for spawned workers to attach
    # (interpreter start + numpy import) before failing the session.
    worker_attach_timeout: float = 120.0
    # process backend: graceful-drain join timeout before SIGKILL.
    worker_stop_timeout: float = 10.0
    # process backend: what to do when a worker dies (or errors, or is
    # watchdog-killed) after the start gate opened, with splinters left:
    #   "none"    — fail the session fast (the default),
    #   "respawn" — spawn a replacement process that attaches to the SAME
    #               arena (go-gate protocol) and reads the unfinished tail,
    #   "reissue" — the supervisor re-reads the unfinished splinters itself
    #               (parent-side fd, straight into the mapped arena).
    # Attach-phase failures stay terminal in every mode: the first-touch
    # placement barrier cannot be re-run once other workers hold data.
    recovery: str = "none"
    # process backend: respawn budget for the whole session; exhausting it
    # fails the session with a descriptive WorkerCrashed.
    max_respawns: int = 2
    # process backend: hung-worker watchdog — a live worker that has made
    # no ring progress for this many seconds while owning unfinished
    # splinters is SIGKILLed (then handled per ``recovery``). 0 = off.
    worker_watchdog_s: float = 0.0
    # Fault-injection hooks (core/faults.py — picklable for the process
    # backend): io_fault plugs into PosixFile.pread_into (short reads /
    # transient OSErrors), ring_fault into EventRing.publish (torn stamps).
    io_fault: Optional[object] = None
    ring_fault: Optional[object] = None
    # test/bench hook: seconds of injected delay before reading a splinter
    # (process backend: must be picklable — see repro_torch.ipc.worker.StallReader)
    delay_model: Optional[Callable[[int, Splinter], float]] = None
    # optional cross-node transfer model (None = immediate hand-off)
    network: Optional["NetworkModel"] = None
    # per-piece delivery timing sample rate (0 = off; N = every Nth piece)
    piece_timing_every: int = 0
    # PE -> NUMA-domain model (core/placement.py). Enables domain-coalesced
    # pieces, cross-domain delivery accounting, and — with prefault_arena —
    # per-stripe first-touch on the owning reader's thread.
    topology: Optional[Topology] = None
    # Pin each reader I/O thread to the host CPUs of its stripe's NUMA
    # domain (requires a topology with a CPU map, e.g. Topology.detect).
    # Best-effort; outcomes are counted in LocalityMetrics.
    numa_pin: bool = False
    # Arena prefault policy. Without a topology this is an
    # up-front zero-fill (a full memset on the start critical path — used by
    # benchmarks as the legacy "before"). WITH a topology it becomes the
    # NUMA first-touch hook instead: each reader thread faults its own
    # stripe's pages (one byte per page, on its own — optionally pinned —
    # thread) before reading, so first-touch places every stripe on its
    # reader's domain without defeating the non-zero-filled np.empty arena.
    prefault_arena: bool = False
    # -- cold-cache read engine (io/submit.py) -------------------------------
    # The file handle was opened O_DIRECT (reads DMA past the page cache).
    # start() validates the arena/plan against the probed block size and
    # raises io.posix.DirectIOError on any structural misalignment.
    direct_io: bool = False
    # In-flight reads per reader thread/worker: 0/1 = the blocking
    # per-splinter loop; >= 2 = depth-managed async
    # submission (io_uring or a preadv pool, see submit_mode).
    queue_depth: int = 0
    # WILLNEED window advised ahead of the submission frontier (bytes;
    # buffered files only — O_DIRECT bypasses the page cache).
    readahead_bytes: int = 0
    # "auto" | "io_uring" | "threads" (io/submit.py make_submitter).
    submit_mode: str = "auto"


class NetworkModel:
    """Deterministic cross-node delivery model (single timer thread).

    ``deliver`` fires ``fn`` after bytes/bw + latency when the transfer
    crosses nodes, immediately otherwise. Used only where a benchmark needs
    to expose locality (everything runs in one address space here, so the
    physical copy cost does not differ by "node" — the model supplies the
    difference and is documented wherever used).
    """

    def __init__(self, bw_bytes_per_s: float = 25e9, latency_s: float = 2e-6):
        self.bw = bw_bytes_per_s
        self.latency = latency_s
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._lock = threading.Condition()
        self._seq = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def transfer_time(self, nbytes: int) -> float:
        return self.latency + nbytes / self.bw

    def deliver(self, nbytes: int, same_node: bool, fn: Callable[[], None]) -> None:
        if same_node:
            fn()
            return
        due = time.monotonic() + self.transfer_time(nbytes)
        with self._lock:
            heapq.heappush(self._heap, (due, self._seq, fn))
            self._seq += 1
            self._lock.notify()

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._heap and not self._stop:
                    self._lock.wait(0.05)
                if self._stop:
                    return
                due, _, fn = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._lock.wait(min(due - now, 0.05))
                    continue
                heapq.heappop(self._heap)
            fn()

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify()


@dataclass
class _Waiter:
    remaining: int
    fire: Callable[[], None]
    # Error channel: invoked (as a scheduler task) with the session error
    # when the backend fails before the awaited range lands. None = no
    # error path (bench/driver waiters that use join() instead).
    fail: Optional[Callable[[BaseException], None]] = None


@dataclass(frozen=True)
class SplinterEvent:
    """One splinter-read completion, as seen by stream subscribers.

    Carries everything a streamed consumer needs to act on the arrival
    without touching the reader set again: identity (global splinter id +
    owning reader), location (absolute file offset and the offset of the
    bytes inside the session arena), size, and the ``perf_counter``
    timestamp of the completion — the anchor for arrival→staged latency.
    """

    index: int          # global splinter id within the session
    reader: int         # owning reader (post-steal: the planned owner)
    offset: int         # absolute file offset
    nbytes: int
    arena_off: int      # byte offset into the session arena
    t_arrival: float    # time.perf_counter() at read completion


class BufferReaderSet:
    """The buffer-chare collective for one read session."""

    def __init__(
        self,
        file: PosixFile,
        plan: StripePlan,
        sched: TaskScheduler,
        reader_pes: List[int],
        opts: ReaderOptions,
        metrics: Optional[SessionMetrics] = None,
    ):
        assert len(reader_pes) >= plan.num_readers
        self.file = file
        self.plan = plan
        self.sched = sched
        self.reader_pes = reader_pes[: plan.num_readers]
        self.opts = opts
        self.metrics = metrics or SessionMetrics()
        if opts.piece_timing_every:
            self.metrics.piece_timing_every = opts.piece_timing_every

        self.locality = LocalityMetrics()
        # FileSet sessions: the handle resolves offsets to shard ids
        # (io.posix.ShardedFile.shard_of); None for single-file sessions.
        # Splinters never span shards (hard stripe bounds), so attributing
        # a whole pread to shard_of(offset) is exact.
        self._shard_of = getattr(file, "shard_of", None)
        # Session storage: stripes are slices of one arena. Readers fill it;
        # clients get zero-copy memoryviews out of it. The allocation is a
        # subclass hook: the process backend substitutes a shared-memory
        # segment mapped into every worker process (same aliasing contract).
        self._arena: np.ndarray = self._alloc_arena(plan)
        self._base = plan.offset

        self._lock = threading.Lock()
        self._done = [False] * len(plan.splinters)
        self._ndone = 0
        # Fatal session error (the process backend's worker-crash path sets
        # it via _fail; the thread backend never does). Checked under
        # ``_lock`` by when_available so registration and failure are
        # atomic: a request lands either before a failure (the raising
        # task unblocks its pump) or raises here — never in between.
        self.error: Optional[BaseException] = None
        self._error_surfaced = False   # one bare raising task per session
        # Global splinter ids in completion order — the staging order a
        # streamed (per-splinter) host→device path would see; consumed by
        # the device-ingest index-map construction (data/packing.py).
        self._arrival: List[int] = []
        # Per-splinter completion stream: recorded events (for subscriber
        # replay) + live subscribers. ``_stream_lock`` serializes deliveries
        # so each subscriber sees events exactly once, in arrival order, and
        # ``unsubscribe`` is a barrier (no callback runs after it returns).
        self._events: List[SplinterEvent] = []
        self._subs: Dict[int, Callable[[SplinterEvent], None]] = {}
        self._next_sub = 0
        self._stream_lock = threading.Lock()
        self._waiters_by_splinter: Dict[int, List[_Waiter]] = {}
        # per-reader deque of unread splinters (lists popped from index 0 /
        # stolen from the end)
        self._pending: List[List[Splinter]] = [
            list(plan.splinters_for_reader(r)) for r in range(plan.num_readers)
        ]
        self._threads: List[threading.Thread] = []
        # NUMA setup gate: count of reader threads whose _thread_setup has
        # not finished. While nonzero, work STEALING is disabled — a steal
        # is the only cross-thread read, and a stolen splinter read before
        # its owner's page-stride first-touch would be corrupted by the
        # touch landing afterwards. Own-stripe reads are always safe (each
        # thread touches its stripes before its first read), so this gate
        # closes the hazard without a start barrier: no timeout, no
        # broken-barrier window, regardless of thread scheduling.
        self._setup_pending = 0
        self._cancelled = False
        self._complete_evt = threading.Event()
        if not plan.splinters:
            self._complete_evt.set()
        self.started = False
        # Borrowed read-only views handed to zero-copy clients; released
        # (invalidated) when the session closes. _pinned_borrows counts the
        # ones a live buffer export kept alive through invalidation — the
        # reader-service arena pool quarantines (never recycles) a segment
        # with a nonzero count, so a pinned view can't alias a later
        # session's bytes.
        self._borrows: List[memoryview] = []
        self._pinned_borrows = 0

    def _alloc_arena(self, plan: StripePlan) -> np.ndarray:
        """Allocate the session arena (subclass hook). np.empty skips the
        memset a bytearray would do — every byte is overwritten by preadv
        anyway, and for multi-GB sessions the zero-fill pass dominated
        session start (it sat on the critical path of the first request).

        Direct-I/O sessions need the arena base on the FS block grid
        (O_DIRECT DMA targets), but numpy only guarantees 16-byte
        alignment for small allocations — over-allocate one block and
        slice to the grid (the parent buffer stays alive through
        ``.base``; costs at most ``block_size`` bytes per session).

        The arena is pageable host memory: a host→device copy from it is
        synchronous with respect to the source (the copy returns once the
        bytes have been consumed), which is what lets the pipeline release
        a session right after staging its window."""
        if getattr(self.file, "direct_io", False):
            bs = getattr(self.file, "block_size", DEFAULT_ALIGN)
            raw = np.empty(plan.nbytes + bs, dtype=np.uint8)
            skew = (-raw.ctypes.data) % bs
            arena = raw[skew: skew + plan.nbytes]
        else:
            arena = np.empty(plan.nbytes, dtype=np.uint8)
        if self.opts.prefault_arena and self.opts.topology is None:
            # Legacy (topology-blind) prefault — explicit memset: np.zeros
            # would calloc lazily-zeroed pages without touching them —
            # fill() actually faults every page in and reproduces the
            # bytearray zero-fill of old. With a topology, prefault happens
            # per stripe on the reader threads instead (_thread_setup).
            arena.fill(0)
        return arena

    def _validate_direct_io(self) -> None:
        """Fail fast when a direct-I/O session cannot satisfy the probed
        block alignment — the no-silent-fallback half of the O_DIRECT
        contract. Checks the arena base (DMA target), the session offset,
        and every splinter's file offset (the splinter grid); sub-block
        *lengths* (tails) are legal — they finish through the buffered fd,
        counted."""
        if not getattr(self.file, "direct_io", False) or not self.plan.nbytes:
            return
        bs = getattr(self.file, "block_size", DEFAULT_ALIGN)
        problems: List[str] = []
        base_addr = self._arena.ctypes.data
        if base_addr % bs:
            problems.append(
                f"arena base 0x{base_addr:x} is not {bs}-byte aligned")
        if self.plan.offset % bs:
            problems.append(
                f"session offset {self.plan.offset} is off the {bs}-byte "
                f"block grid")
        bad_sp = [sp for sp in self.plan.splinters if sp.offset % bs]
        if bad_sp:
            problems.append(
                f"{len(bad_sp)} splinter offset(s) off the {bs}-byte grid "
                f"(first: splinter {bad_sp[0].index} at {bad_sp[0].offset}) "
                f"— plan the session with align=fs_block_size(path)")
        # Arena positions must land on the grid too (the DMA destination is
        # base + (sp.offset - plan.offset); with base and plan.offset
        # aligned this follows from aligned splinter offsets, so no extra
        # scan is needed).
        if problems:
            raise DirectIOError(
                "direct_io=True cannot run this session: "
                + "; ".join(problems))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Begin greedy prefetch: every reader starts reading immediately
        (paper Fig. 5: "Buffer Chares begin reading on session instantiation,
        without waiting for client requests")."""
        if self.started:
            return
        self._validate_direct_io()
        self.started = True
        # Recorded here (not only in the async loop) so blocking-path
        # sessions still report their open mode.
        self.metrics.direct_io = bool(getattr(self.file, "direct_io", False))
        nthreads = min(
            max(1, self.plan.num_readers), max(1, self.opts.max_io_threads)
        )
        if self.opts.queue_depth >= 2:
            # Each reader thread builds its own engine; a forced io_uring
            # that cannot run (a sharded file, a kernel that refuses the
            # ring) fails the session start here, not a reader thread.
            ring_selected(self.file, self.opts.submit_mode,
                          self.opts.delay_model)
        if self.opts.topology is not None and (
                self.opts.prefault_arena or self.opts.numa_pin):
            # Defer stealing until every thread's pin+first-touch setup is
            # done (see _setup_pending). Setup is microseconds (a syscall
            # + strided writes), so the gate lifts as soon as the last
            # thread is scheduled.
            self._setup_pending = nthreads
        self.metrics.session_started(self.plan.nbytes, self.plan.num_readers)
        if self.plan.nbytes:
            # Kick kernel readahead for the whole session before the first
            # pread lands (greedy prefetch starts now anyway).
            self.file.advise_sequential(self.plan.offset, self.plan.nbytes,
                                        stats=self.metrics.recovery)
        for t in range(nthreads):
            th = threading.Thread(
                target=self._reader_main, args=(t, nthreads), daemon=True
            )
            self._threads.append(th)
            th.start()

    def cancel(self) -> None:
        self._cancelled = True

    def stop(self, timeout: float = 10.0) -> bool:
        """Cancel and join the reader threads (file-close barrier).

        Returns True when every thread exited — only then is it safe to
        close the underlying file. False means a straggler survived the
        per-thread join timeout (e.g. a pread stalled on a dying FS) and
        may still touch the fd; the caller must not close it."""
        self._cancelled = True
        ok = True
        for th in self._threads:
            if th.is_alive():
                th.join(timeout)
                ok &= not th.is_alive()
        return ok

    def join(self, timeout: float = 120.0) -> bool:
        """Wait for all splinters to be resident (bench/driver use only —
        application code uses `when_available`/callbacks instead)."""
        return self._complete_evt.wait(timeout)

    @property
    def complete(self) -> bool:
        return self._complete_evt.is_set()

    def progress(self) -> Tuple[int, int]:
        with self._lock:
            return self._ndone, len(self._done)

    def arrival_order(self) -> Tuple[int, ...]:
        """Global splinter ids in the order their reads completed (snapshot).

        A permutation of ``range(len(plan.splinters))`` once the session is
        complete; work stealing and stragglers make it differ from file
        order, which is exactly what the device-side reassembly index maps
        (``data/packing.py``) consume."""
        with self._lock:
            return tuple(self._arrival)

    # -- reader threads -------------------------------------------------------
    def _next_splinter(self, tid: int, nthreads: int) -> Optional[Splinter]:
        """Pop own work first; steal from the most-backlogged reader if idle."""
        with self._lock:
            # own readers: reader indices congruent to tid (thread pool may be
            # smaller than the reader count)
            for r in range(tid, self.plan.num_readers, nthreads):
                if self._pending[r]:
                    return self._pending[r].pop(0)
            if self.opts.work_stealing and self._setup_pending == 0:
                victim = max(
                    range(self.plan.num_readers),
                    key=lambda r: len(self._pending[r]),
                    default=None,
                )
                if victim is not None and self._pending[victim]:
                    self.metrics.record_steal(victim)
                    return self._pending[victim].pop()  # steal from the tail
        return None

    def _thread_setup(self, tid: int, nthreads: int) -> None:
        """Per-I/O-thread NUMA placement, before the first read.

        With a topology: first-touch-fault the pages of every stripe this
        thread owns (``prefault_arena``) — with ``numa_pin``, pinned to
        *that stripe's* domain CPUs while touching it (a thread can own
        stripes in several domains when the pool is smaller than the
        reader count; re-pinning per domain is a cheap syscall and it is
        the touch-time affinity that decides first-touch placement), then
        settle on the primary stripe's domain for the read loop. Under
        Linux first-touch each stripe's memory thus lands on its own
        domain, one byte written per page, never a whole-arena zero-fill.
        Stolen splinters later read into already-placed pages, so
        straggler stealing cannot scatter a stripe across domains.
        """
        topo = self.opts.topology
        if topo is None:
            return
        owned = range(tid, self.plan.num_readers, nthreads)
        if not len(owned):
            return
        pinned_dom = [None]
        pin_outcomes: List[bool] = []

        def pin_to(dom: int) -> None:
            if not self.opts.numa_pin or dom == pinned_dom[0]:
                return
            cpus = topo.cpus_of_domain(dom)
            pin_outcomes.append(bool(cpus) and pin_thread_to_cpus(cpus))
            pinned_dom[0] = dom
        if self.opts.prefault_arena:
            for r in owned:
                lo, hi = self.plan.stripe_bounds[r]
                if hi > lo:
                    pin_to(self.reader_domain(r))
                    pages = first_touch(
                        self._arena[lo - self._base: hi - self._base])
                    self.locality.record_prefault(pages)
        pin_to(self.reader_domain(owned[0]))   # read-loop affinity
        if pin_outcomes:
            # One record per THREAD (the counter's name and the verify
            # docs read it as a thread count): success only if every
            # re-pin along the way (one per owned domain) succeeded.
            self.locality.record_pin(all(pin_outcomes))

    def _reader_main(self, tid: int, nthreads: int) -> None:
        gated = self._setup_pending > 0     # set before threads start
        if gated:
            try:
                self._thread_setup(tid, nthreads)
            finally:
                with self._lock:
                    self._setup_pending -= 1
        if self.opts.queue_depth >= 2:
            self._reader_main_async(tid, nthreads)
            return
        while not self._cancelled:
            sp = self._next_splinter(tid, nthreads)
            if sp is None:
                if not self.opts.work_stealing:
                    return            # own stripes drained; nothing to steal
                with self._lock:
                    has_work = any(self._pending)
                    gated = self._setup_pending > 0
                if not has_work:
                    return
                # Unclaimed splinters remain. Either stealing is still
                # setup-gated (spin briefly — the gate lifts within
                # microseconds of the last thread being scheduled) or the
                # gate lifted between our failed pop and this check —
                # retry immediately rather than exiting and silently
                # leaving the session without a thief.
                if gated:
                    time.sleep(0.0005)
                continue
            if self.opts.delay_model is not None:
                d = self.opts.delay_model(sp.reader, sp)
                if d > 0:
                    time.sleep(d)
            t0 = time.perf_counter()
            lo = sp.offset - self._base
            view = memoryview(self._arena)[lo : lo + sp.nbytes]
            n = self.file.pread_into(sp.offset, view,
                                     stats=self.metrics.recovery,
                                     fault=self.opts.io_fault)
            dt = time.perf_counter() - t0
            if n != sp.nbytes and not self._cancelled:
                raise IOError(
                    f"short read: wanted {sp.nbytes} at {sp.offset}, got {n}"
                )
            self.metrics.record_read(sp.reader, sp.nbytes, dt)
            if self._shard_of is not None:
                self.metrics.record_shard_read(self._shard_of(sp.offset),
                                               sp.nbytes)
            if self.opts.topology is not None:
                # Splinter-size histogram (per-reader sizing observable);
                # skipped without a topology to keep the default read loop
                # free of the extra lock acquisition.
                self.locality.record_splinter(sp.reader, sp.nbytes)
            self._mark_done(sp)

    def _reader_main_async(self, tid: int, nthreads: int) -> None:
        """Depth-managed drain: same work source (``_next_splinter`` — so
        stealing survives), same completion fan-out (``_mark_done``), but
        up to ``queue_depth`` splinter reads in flight through
        ``io/submit.py`` instead of one blocking pread at a time."""
        opts = self.opts
        delay = None
        if opts.delay_model is not None:
            dm = opts.delay_model

            def delay(sp, nbytes):
                d = dm(sp.reader, sp)
                if d > 0:
                    time.sleep(d)
        eng = AsyncReadEngine(
            self.file, opts.queue_depth,
            readahead_bytes=opts.readahead_bytes,
            mode=opts.submit_mode,
            stats=self.metrics.recovery,
            fault=opts.io_fault,
            delay=delay,
        )
        self.metrics.record_submit_config(
            opts.queue_depth, opts.readahead_bytes, eng.kind,
            bool(getattr(self.file, "direct_io", False)))

        def next_item():
            while not self._cancelled:
                sp = self._next_splinter(tid, nthreads)
                if sp is not None:
                    lo = sp.offset - self._base
                    view = memoryview(self._arena)[lo: lo + sp.nbytes]
                    return (sp, sp.offset, view)
                if not opts.work_stealing:
                    return None
                with self._lock:
                    has_work = any(self._pending)
                    g = self._setup_pending > 0
                if not has_work:
                    return None
                # Unclaimed splinters remain but stealing is setup-gated
                # (or the gate lifted between the failed pop and this
                # check) — retry, same as the synchronous loop.
                if g:
                    time.sleep(0.0005)
            return None

        def on_complete(sp, n, dt):
            if n != sp.nbytes and not self._cancelled:
                raise IOError(
                    f"short read: wanted {sp.nbytes} at {sp.offset}, got {n}"
                )
            # Folded per completion (not only in the finally below): join()
            # wakes on the last _mark_done, possibly before this thread's
            # engine teardown runs — the high-water mark must already be
            # visible to that waiter.
            self.metrics.record_inflight_hwm(eng.max_inflight)
            self.metrics.record_read(sp.reader, sp.nbytes, dt)
            if self._shard_of is not None:
                self.metrics.record_shard_read(self._shard_of(sp.offset),
                                               sp.nbytes)
            if opts.topology is not None:
                self.locality.record_splinter(sp.reader, sp.nbytes)
            self._mark_done(sp)

        try:
            eng.run(next_item, on_complete, stop=lambda: self._cancelled)
        finally:
            self.metrics.record_inflight_hwm(eng.max_inflight)

    def _mark_done(self, sp: Splinter, t_arrival: Optional[float] = None) -> None:
        """Record one splinter completion and fan out waiters/subscribers.

        ``t_arrival`` defaults to now; the process backend passes the
        worker-side completion timestamp instead (``perf_counter`` is
        CLOCK_MONOTONIC on Linux — comparable across processes)."""
        to_fire: List[Callable[[], None]] = []
        ev = SplinterEvent(
            index=sp.index,
            reader=sp.reader,
            offset=sp.offset,
            nbytes=sp.nbytes,
            arena_off=sp.offset - self._base,
            t_arrival=time.perf_counter() if t_arrival is None else t_arrival,
        )
        # _stream_lock spans the record + delivery so concurrent completions
        # reach every subscriber in the same order they enter ``_events``
        # (== ``_arrival`` order).
        with self._stream_lock:
            with self._lock:
                self._done[sp.index] = True
                self._ndone += 1
                self._arrival.append(sp.index)
                self._events.append(ev)
                if self._ndone == len(self._done):
                    self._complete_evt.set()
                for w in self._waiters_by_splinter.pop(sp.index, ()):  # type: ignore[arg-type]
                    w.remaining -= 1
                    if w.remaining == 0:
                        to_fire.append(w.fire)
                subs = list(self._subs.values()) if self._subs else ()
            for cb in subs:
                cb(ev)
        if not to_fire:
            return
        # One splinter can release many waiters; batch their enqueues into a
        # single scheduler lock/notify round.
        with self.sched.batch():
            for fire in to_fire:
                fire()

    # -- splinter completion stream -------------------------------------------
    def subscribe(
        self, cb: Callable[[SplinterEvent], None], replay: bool = True
    ) -> int:
        """Register ``cb`` for per-splinter completion events; returns a token.

        ``cb`` runs on the completing I/O thread and must be cheap (enqueue a
        scheduler task — the split-phase rule) and must not call
        ``subscribe``/``unsubscribe`` inline (delivery holds the stream lock).
        With ``replay=True`` (default), splinters that completed before the
        subscription are delivered first, in arrival order, before any new
        event — a subscriber attached mid-session misses nothing.
        """
        with self._stream_lock:
            with self._lock:
                token = self._next_sub
                self._next_sub += 1
                past = list(self._events) if replay else []
                self._subs[token] = cb
            for ev in past:
                cb(ev)
        return token

    def unsubscribe(self, token: int) -> None:
        """Remove a stream subscriber. Barrier semantics: once this returns,
        the callback will not be invoked again (any in-flight delivery has
        completed — both paths hold the stream lock)."""
        with self._stream_lock:
            with self._lock:
                self._subs.pop(token, None)

    def events(self) -> Tuple[SplinterEvent, ...]:
        """Snapshot of recorded completion events (arrival order)."""
        with self._lock:
            return tuple(self._events)

    # -- client-facing --------------------------------------------------------
    def when_available(
        self,
        abs_off: int,
        nbytes: int,
        fire: Callable[[], None],
        on_error: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        """Invoke ``fire`` once every byte of the range is resident.

        Thread-safe. ``fire`` must be cheap (it enqueues a scheduler task).
        If the data is already resident the callback runs immediately in the
        caller — the paper's "request buffered until the I/O is finished"
        semantics, with the buffered case handled by the waiter table.

        ``on_error`` is the failure channel (process backend): if the
        session dies before the range lands, ``on_error(exc)`` is delivered
        as a scheduler task instead of ``fire`` — exactly once per waiter.
        A request arriving after the failure raises synchronously here.
        """
        need = [
            s.index
            for s in splinters_covering(self.plan, abs_off, nbytes)
        ]
        with self._lock:
            if self.error is not None:
                raise self.error
            missing = [i for i in need if not self._done[i]]
            if missing:
                w = _Waiter(remaining=len(missing), fire=fire,
                            fail=on_error)
                for i in missing:
                    self._waiters_by_splinter.setdefault(i, []).append(w)
                return
        fire()

    def view(self, abs_off: int, nbytes: int) -> memoryview:
        """Zero-copy view of resident session bytes (the paper's zero-copy
        buffer→assembler hand-off; the Manager's tag table reduces to arena
        offsets in a shared address space)."""
        lo = abs_off - self._base
        return memoryview(self._arena)[lo : lo + nbytes]

    def borrow_view(self, abs_off: int, nbytes: int) -> memoryview:
        """Read-only zero-copy view handed to a client (``read(dest=None)``).

        Session-lifetime borrow: the view is tracked and *released* when the
        session closes, so use-after-close raises ``ValueError`` instead of
        silently reading recycled memory."""
        lo = abs_off - self._base
        mv = memoryview(self._arena)[lo : lo + nbytes].toreadonly()
        with self._lock:
            self._borrows.append(mv)
        return mv

    def invalidate_borrows(self) -> int:
        """Release every borrowed view (close_read_session). Returns count.

        A view with a live buffer export (e.g. an ``np.frombuffer`` array the
        client still holds) cannot be released — Python pins the memory for
        the exporter, so this stays memory-safe; the borrow is dropped from
        tracking and dies when the last exporter does."""
        with self._lock:
            borrows, self._borrows = self._borrows, []
        n = 0
        pinned = 0
        for mv in borrows:
            try:
                mv.release()
                n += 1
            except BufferError:   # live export pins the arena; safe to skip
                pinned += 1
        with self._lock:
            self._pinned_borrows += pinned
        return n

    def claim_error_surface(self) -> bool:
        """One-shot claim on surfacing this session's error as a *bare
        raising task* (for failed requests with no future to route the
        error into). Capped at one per session: the first raising task
        unblocks whichever pump is waiting, and a second one would linger
        in the queue to explode out of an unrelated later pump (e.g. the
        pipeline's teardown flush)."""
        with self._lock:
            if self._error_surfaced:
                return False
            self._error_surfaced = True
            return True

    def release(self) -> None:
        """Free backend resources after the session closed (no-op for the
        thread backend — the arena is ordinary process memory; the process
        backend unmaps/unlinks its shared-memory segments here)."""

    def reader_pe(self, r: int) -> int:
        return self.reader_pes[r]

    def reader_node(self, r: int) -> int:
        return self.sched.node_of(self.reader_pes[r])

    def reader_domain(self, r: int) -> int:
        """NUMA domain of reader ``r``'s PE (node granularity when no
        topology is configured — one memory domain per address space)."""
        pe = self.reader_pes[r]
        topo = self.opts.topology
        return topo.domain_of(pe) if topo is not None else \
            self.sched.node_of(pe)

    def reader_locality(self, r: int) -> Tuple[int, int]:
        """(node, domain) of reader ``r`` — the piece-coalescing key.

        Keyed on both so coalescing never merges across a scheduler node
        even when the topology's domain grid does not nest inside the
        node grid (a merged piece is attributed to its first reader, so a
        node-spanning merge would skip the NetworkModel transfer and
        miscount cross-node bytes for the tail of the piece)."""
        pe = self.reader_pes[r]
        topo = self.opts.topology
        node = self.sched.node_of(pe)
        return (node, topo.domain_of(pe) if topo is not None else node)


def _exit_status(code: Optional[int]) -> str:
    """A worker's exit status for an error message (``code -7`` names
    SIGBUS: a first touch past a full ``/dev/shm``)."""
    if code is not None and code < 0:
        try:
            return f"signal {signal.Signals(-code).name}"
        except ValueError:
            pass
    return f"code {code}"


class ProcessReaderSet(BufferReaderSet):
    """Multi-process reader backend (``FileOptions(backend="process")``).

    The paper's buffer chares as real OS processes: the session arena is a
    shared-memory segment (``ipc/shm.py``) mapped into every reader worker
    process (``ipc/worker.py``) and this consumer process; splinter
    completions cross the process boundary through per-worker
    sequence-numbered event rings (``ipc/ring.py``) drained by a supervisor
    poller thread that re-enters the inherited ``_mark_done`` machinery —
    waiters, the splinter stream (``subscribe``/``read_stream``) and the
    streaming pipeline consume worker-process events transparently.

    Zero-copy delivery survives the split: ``view``/``borrow_view`` return
    memoryviews into the *mapped* arena, so ``bytes_copied`` stays 0 in the
    consumer process. The thread backend's NUMA striping carries over: each worker
    first-touch-faults (and with ``numa_pin`` ``sched_setaffinity``-pins
    itself to) its own stripes before the supervisor opens the start gate,
    so domain placement is decided by the owning *process* and pinning
    spans real CPU sets.

    Lifecycle (the supervisor half of the ``ipc/worker.py`` protocol):
    ``start`` starts workers (fresh interpreters, ``ipc/worker.py``
    ``WorkerProcess`` — no fork of this process's threads or CUDA context)
    + the poller; the poller waits for every worker to
    attach, records their first-touch/pin reports, unlinks the segment
    names (mappings keep them alive — after this point a parent crash
    leaks nothing in ``/dev/shm``: orphaned workers notice the vanished
    supervisor via the getppid() checks polled in every wait loop and
    exit, and the last mapping frees the pages; only a SIGKILL landing in
    the short spawn→attach window can leave named segments behind), opens
    the gates (recording each worker's pid and the spawn → attached time
    in the session metrics), then drains rings until the session is
    complete. A worker that reports ``ERROR`` — or vanishes before
    ``DONE`` — fails the session fast: ``join``/``wait_attached`` raise,
    pending waiters are dropped, and a raising task is enqueued so any
    scheduler-pumping read call surfaces a descriptive :class:`WorkerCrashed`
    within one poll interval instead of hanging. ``stop``/``cancel``
    request a graceful drain (workers exit between splinters) and the
    poller SIGKILLs survivors after ``worker_stop_timeout``. At shutdown
    each finished worker's report (submit backend, in-flight high-water
    mark, direct tails) and its ring's I/O counters fold into the session
    metrics.

    Deliberate differences from the thread backend: no work stealing (the
    pending queues cannot be shared), ``delay_model``/``worker_fault`` must
    be picklable, and a worker process pins once (its primary stripe's
    domain) rather than re-pinning per stripe.

    Fault recovery (``ReaderOptions(recovery=...)``): with recovery
    enabled, a worker that dies, errors, or trips the no-progress watchdog
    *after* the start gate opened no longer fails the session — its
    unfinished splinters are re-routed, either to a replacement process
    attached to the same arena (``"respawn"``, bounded by
    ``max_respawns``) or to an emergency supervisor-side reader
    (``"reissue"``). Both paths re-enter ``_mark_done``, so waiters,
    subscriber order/replay, the arrival log and zero-copy delivery all
    behave as if the original worker had read the bytes — double delivery
    is impossible (``_done[index]`` already gates it) and ``bytes_copied``
    stays 0 (the bytes land in the same shared pages). Attach-phase
    failures remain terminal in every mode: the first-touch placement
    barrier cannot be re-run. Recovery observables land in
    ``metrics.recovery`` (:class:`~repro_torch.core.metrics.RecoveryMetrics`).
    """

    def __init__(
        self,
        file: PosixFile,
        plan: StripePlan,
        sched: TaskScheduler,
        reader_pes: List[int],
        opts: ReaderOptions,
        metrics: Optional[SessionMetrics] = None,
    ):
        self._shm: Optional[SharedArena] = None
        super().__init__(file, plan, sched, reader_pes, opts, metrics)
        self._rings_shm: Optional[SharedArena] = None
        self._rings: List[EventRing] = []
        self._procs: List[object] = []
        self._poller: Optional[threading.Thread] = None
        self._attached_evt = threading.Event()
        self._gates_open = False
        # -- recovery state (supervisor thread only, except where noted) --
        # per-worker splinter assignment (parallel to _procs/_rings; what a
        # recovery has to re-route), retirement flags (a retired worker is
        # excluded from liveness checks — its work moved elsewhere), and
        # last-ring-progress stamps (the watchdog's signal).
        self._worker_splinters: List[Tuple[Splinter, ...]] = []
        self._worker_retired: List[bool] = []
        self._last_progress: List[float] = []
        # respawned worker -> (attach deadline, failure-detection stamp);
        # its gate opens individually as soon as it attaches.
        self._pending_attach: Dict[int, Tuple[float, float]] = {}
        # respawned workers get their own ring segments (the original ring
        # block's name is unlinked at gate open); unlinked at their own
        # gate open, closed at shutdown.
        self._extra_ring_shms: Dict[int, SharedArena] = {}
        self._respawns_used = 0
        self._reissue_threads: List[threading.Thread] = []
        self._workers_shutdown = False   # one-shot guard (io-counter fold)
        self._t_spawn = 0.0              # perf_counter at the first spawn

    def _alloc_arena(self, plan: StripePlan) -> np.ndarray:
        # Named shm segment instead of private np.empty: ftruncate allocates
        # lazily, so no page is faulted here — first touch happens in the
        # worker that owns the stripe (the cross-process analog of the
        # per-thread first-touch; the legacy zero-fill prefault does not
        # apply to this backend). The mapping is page-aligned, so an
        # O_DIRECT session's arena base is on the block grid.
        self._shm = SharedArena.create(plan.nbytes, tag="sess")
        return self._shm.ndarray()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.started:
            return
        self._validate_direct_io()
        self.started = True
        self.metrics.direct_io = bool(getattr(self.file, "direct_io", False))
        self.metrics.session_started(self.plan.nbytes, self.plan.num_readers)
        if self.opts.queue_depth >= 2:
            # Workers build their engines themselves and report the backend
            # they took (folded in at shutdown); the same selection rule
            # runs here first, so a forced io_uring that cannot run fails
            # the session start, not a worker.
            kind = "io_uring" if ring_selected(
                self.file, self.opts.submit_mode,
                self.opts.delay_model) else "threads"
            self.metrics.record_submit_config(
                self.opts.queue_depth, self.opts.readahead_bytes, kind,
                bool(getattr(self.file, "direct_io", False)))
        if not self.plan.splinters:
            self._gates_open = True          # trivially: nothing to attach
            self._attached_evt.set()
            return
        # Readahead from the parent helps too: the page cache is shared
        # with the workers.
        self.file.advise_sequential(self.plan.offset, self.plan.nbytes,
                                    stats=self.metrics.recovery)
        nworkers = min(self.plan.num_readers, max(1, self.opts.max_workers))
        rb = ring_bytes(self.opts.ring_slots)
        self._rings_shm = SharedArena.create(nworkers * rb, tag="rings")
        region = self._rings_shm.buf
        topo = self.opts.topology
        self._t_spawn = time.perf_counter()
        try:
            self._spawn_workers(nworkers, rb, region, topo)
        except BaseException:
            # Spawn failed (unpicklable delay/fault hook, resource error):
            # the poller that would normally unlink the named segments and
            # reap workers will never run — run its teardown here or the
            # tmpfs names (and any already-started worker) leak forever.
            self._shutdown_workers()
            self._procs = []
            raise
        self._poller = threading.Thread(
            target=self._poll_main, daemon=True, name="ckio-ring-poller")
        self._poller.start()

    def _spawn_workers(self, nworkers: int, rb: int,
                       region: memoryview, topo: Optional[Topology]) -> None:
        for w in range(nworkers):
            self._rings.append(EventRing(
                region[w * rb: (w + 1) * rb], self.opts.ring_slots,
                create=True,
            ))
            owned = list(range(w, self.plan.num_readers, nworkers))
            pin_cpus = None
            if self.opts.numa_pin and topo is not None and owned:
                cpus = topo.cpus_of_domain(self.reader_domain(owned[0]))
                pin_cpus = tuple(cpus) if cpus else None
            spec = WorkerSpec(
                worker_id=w,
                file_path=self.file.path,
                arena_path=self._shm.path,
                arena_bytes=self.plan.nbytes,
                base_offset=self._base,
                ring_path=self._rings_shm.path,
                ring_region_bytes=nworkers * rb,
                ring_offset=w * rb,
                ring_slots=self.opts.ring_slots,
                splinters=tuple(
                    sp for r in owned
                    for sp in self.plan.splinters_for_reader(r)),
                stripe_bounds=tuple(
                    self.plan.stripe_bounds[r] for r in owned),
                prefault=self.opts.prefault_arena,
                pin_cpus=pin_cpus,
                delay_model=self.opts.delay_model,
                fault=self.opts.worker_fault,
                io_fault=self.opts.io_fault,
                ring_fault=self.opts.ring_fault,
                parent_pid=os.getpid(),
                shards=getattr(self.file, "worker_segments", None),
                direct_io=self.opts.direct_io,
                queue_depth=self.opts.queue_depth,
                readahead_bytes=self.opts.readahead_bytes,
                submit_mode=self.opts.submit_mode,
            )
            self._worker_splinters.append(spec.splinters)
            self._worker_retired.append(False)
            self._last_progress.append(time.monotonic())
            self._procs.append(WorkerProcess(spec, name=f"ckio-reader-{w}"))
        try:
            for p in self._procs:
                p.start()
        finally:
            # Every started worker gets its spec, also when a later start
            # failed: it then attaches and exits at the stop request of the
            # teardown instead of waiting on stdin until it is killed.
            for p in self._procs:
                p.send()

    def wait_attached(self, timeout: float = 120.0) -> bool:
        """Block until every worker has attached + placed its stripes (the
        supervisor opened the start gates) — the point where drain timing
        starts in benchmarks. Raises if the session already failed;
        returns False if it was cancelled (or timed out) before the gates
        opened, rather than sleeping out the timeout on a torn-down
        session (cancel and poller exit both wake this event)."""
        ok = self._attached_evt.wait(timeout)
        if self.error is not None:
            raise self.error
        return ok and self._gates_open

    def worker_pids(self) -> List[int]:
        """Live (non-retired) worker pids, ring-reported — what a fault
        harness SIGKILLs to exercise recovery from outside."""
        return [self._rings[w].pid()
                for w in range(len(self._rings))
                if not self._worker_retired[w] and self._rings[w].pid()]

    def cancel(self) -> None:
        self._cancelled = True
        for ring in list(self._rings):
            ring.request_stop()
        # Wake anyone parked on the attach barrier of a session that will
        # now never open its gates (wait_attached returns False).
        self._attached_evt.set()

    def stop(self, timeout: float = 30.0) -> bool:
        """Graceful drain + join (SIGKILL on timeout happens in the
        poller's shutdown); True once poller and workers are gone."""
        self.cancel()
        th = self._poller
        if th is not None and th.is_alive():
            th.join(timeout)
            if th.is_alive():
                return False
        return all(not p.is_alive() for p in self._procs)

    def join(self, timeout: float = 120.0) -> bool:
        ok = self._complete_evt.wait(timeout)
        if self.error is not None:
            raise self.error
        return ok

    def release(self) -> None:
        """Unmap/unlink the shm segments once the session is closed.

        Joins the (cancelled) poller first — it owns the ring mappings.
        The arena unmap is best-effort: any chunk view still pinned by a
        staged device transfer keeps its pages alive until the exporter
        dies (the names were already unlinked, so nothing leaks)."""
        th = self._poller
        if th is not None and th.is_alive():
            self.cancel()
            th.join(self.opts.worker_stop_timeout + 15.0)
            if th.is_alive():      # stuck worker: leave mappings to GC
                return
        if self._shm is not None:
            # Best-effort: ``self._arena`` still exports the mapping (late
            # piece-delivery tasks racing the close may read through it,
            # exactly like the thread backend's arena), so close() here
            # typically only unlinks; the pages are freed the moment the
            # last exporter — the session object itself — is dropped.
            self._shm.close()

    # -- supervisor poller ----------------------------------------------------
    def _on_ring_event(self, ev: RingEvent) -> None:
        sp = Splinter(reader=ev.reader, index=ev.index,
                      offset=ev.offset, nbytes=ev.nbytes)
        self.metrics.record_read(ev.reader, ev.nbytes, ev.read_dt)
        if self._shard_of is not None:
            self.metrics.record_shard_read(self._shard_of(ev.offset),
                                           ev.nbytes)
        if self.opts.topology is not None:
            self.locality.record_splinter(ev.reader, ev.nbytes)
        self._mark_done(sp, t_arrival=ev.t_arrival)

    def _fail(self, exc: BaseException) -> None:
        """Fail the session fast: record the error, unblock every waiter
        path (join / wait_attached / scheduler pumps) with it."""
        with self._lock:
            if self.error is not None:
                return
            self.error = exc
            waiters: List[_Waiter] = []
            seen = set()
            for ws in self._waiters_by_splinter.values():
                for w in ws:
                    if id(w) not in seen:         # distinct, once each
                        seen.add(id(w))
                        waiters.append(w)
            self._waiters_by_splinter.clear()
            self._complete_evt.set()
        self._attached_evt.set()

        def raise_error() -> None:
            raise exc

        # Every registered waiter gets the error through its own failure
        # channel (the assembler routes it to the request's future /
        # callback — exactly once per request), so EVERY blocked caller
        # fails fast, not just whichever pump pops a task first. A waiter
        # without an error channel (bench/driver join()-style code) gets a
        # raising task to unblock its pump. Requests arriving after the
        # failure raise synchronously in when_available, so nothing is
        # delivered twice.
        with self.sched.batch():
            for w in waiters:
                if w.fail is not None:
                    self.sched.enqueue(0, w.fail, exc, label="ckio-read-error")
                elif self.claim_error_surface():
                    # Channel-less waiters share one raising task (see
                    # claim_error_surface).
                    self.sched.enqueue(0, raise_error,
                                       label="ckio-worker-error")

    def _worker_label(self, w: int) -> str:
        ring, p = self._rings[w], self._procs[w]
        pid = ring.pid() or getattr(p, "pid", None)
        return f"reader worker {w} (pid {pid})"

    def _poll_main(self) -> None:
        total = len(self._done)
        gated = True
        deadline = time.monotonic() + self.opts.worker_attach_timeout
        pause = 50e-6
        try:
            while not self._cancelled:
                progressed = 0
                for w in range(len(self._rings)):
                    events = self._rings[w].consume(limit=1024)
                    for ev in events:
                        self._on_ring_event(ev)
                    if events:
                        self._last_progress[w] = time.monotonic()
                    progressed += len(events)
                if gated:
                    # Initial attach barrier. Recovery never runs while
                    # gated (attach-phase failures are terminal — see
                    # _handle_worker_failure), so _rings still holds
                    # exactly the original workers here.
                    states = [r.state() for r in self._rings]
                    if any(st == ST_ERROR for st in states):
                        # A worker died during attach: do NOT open gates or
                        # report attachment — fall through to the dead-
                        # child loop below, which fails the session
                        # (wait_attached then raises instead of returning
                        # success on a dying session).
                        pass
                    elif all(st != ST_INIT for st in states):
                        for ring in self._rings:
                            pages, pin = ring.touch_report()
                            if pages:
                                self.locality.record_prefault(pages)
                            if pin != PIN_NONE:
                                self.locality.record_pin(pin == PIN_OK)
                            ring.open_gate()
                        # Names are no longer needed (everyone holds a
                        # mapping): unlink now so nothing leaks in
                        # /dev/shm even if this process dies. With
                        # recovery="respawn" the ARENA name must survive —
                        # a replacement worker attaches to it by name — so
                        # its unlink waits for _shutdown_workers (the
                        # SIGKILL-leak window widens from spawn→attach to
                        # the session lifetime; that is the price of
                        # in-place respawn and it is opt-in).
                        if self.opts.recovery != "respawn":
                            self._shm.unlink()
                        self._rings_shm.unlink()
                        gated = False
                        self._gates_open = True
                        now = time.monotonic()
                        for w in range(len(self._last_progress)):
                            self._last_progress[w] = now
                        self.metrics.record_workers_attached(
                            [r.pid() for r in self._rings],
                            time.perf_counter() - self._t_spawn)
                        self._attached_evt.set()
                    elif time.monotonic() > deadline:
                        waiting = [w for w, r in enumerate(self._rings)
                                   if r.state() == ST_INIT]
                        self._fail(WorkerCrashed(
                            f"reader worker(s) {waiting} failed to attach "
                            f"within {self.opts.worker_attach_timeout}s"))
                        return
                if self._pending_attach and not self._check_pending_attach():
                    return
                with self._lock:
                    if self._ndone >= total:
                        return
                if not gated:
                    self._watchdog_sweep()
                for w in range(len(self._procs)):
                    if self._worker_retired[w]:
                        continue
                    p, ring = self._procs[w], self._rings[w]
                    st = ring.state()
                    if st != ST_ERROR and (st == ST_DONE or p.is_alive()):
                        continue
                    # Dead or errored. Drain anything it published before
                    # dying, then decide: the session may actually be
                    # complete.
                    events = ring.consume()
                    for ev in events:
                        self._on_ring_event(ev)
                    progressed += len(events)
                    with self._lock:
                        ndone = self._ndone
                    if ndone >= total:
                        return
                    if ring.state() == ST_ERROR:
                        msg = (f"{self._worker_label(w)} failed: "
                               f"{ring.error_message()}")
                    else:
                        msg = (f"{self._worker_label(w)} exited with "
                               f"{_exit_status(p.exitcode)} before "
                               f"completing its splinters ({ndone}/{total} "
                               f"read)")
                    if not self._handle_worker_failure(w, msg, gated):
                        return
                if progressed:
                    pause = 50e-6
                else:
                    time.sleep(pause)
                    pause = min(pause * 2, 2e-3)   # futex-free backoff
        finally:
            self._shutdown_workers()
            # Whatever ended the poll loop, nobody may stay parked on the
            # attach barrier of a dead session.
            self._attached_evt.set()

    # -- recovery (supervisor thread) -----------------------------------------
    def _shard_attribution(
            self, splinters: List[Splinter]) -> Optional[Dict[int, int]]:
        """FileSet sessions: re-routed bytes per shard id (splinters never
        span shards). None for single-file sessions."""
        if self._shard_of is None:
            return None
        by: Dict[int, int] = {}
        for sp in splinters:
            sh = self._shard_of(sp.offset)
            by[sh] = by.get(sh, 0) + sp.nbytes
        return by

    def _unfinished(self, w: int) -> List[Splinter]:
        """Splinters assigned to worker ``w`` that have not landed (its
        ring must be drained first so nothing already-published counts)."""
        with self._lock:
            return [sp for sp in self._worker_splinters[w]
                    if not self._done[sp.index]]

    def _retire_worker(self, w: int) -> None:
        self._worker_retired[w] = True
        self._pending_attach.pop(w, None)

    def _handle_worker_failure(self, w: int, msg: str, gated: bool) -> bool:
        """A worker died / errored (ring drained). Recover per
        ``opts.recovery`` or fail the session; returns True when the
        session should keep running.

        Attach-phase failures are always terminal: the go-gate exists so
        every stripe's first-touch placement completes before any read,
        and that collective barrier cannot be re-run once gates opened.
        Post-gate, a replacement skips prefault entirely (stripe pages
        either carry placement from the dead worker's touch or hold
        already-read data a re-touch would corrupt — first_touch writes).
        """
        unfinished = self._unfinished(w)
        self._retire_worker(w)
        if not unfinished:
            # Everything it owned already landed (e.g. died after its last
            # publish but before ST_DONE) — nothing to recover.
            return True
        mode = self.opts.recovery
        if gated or mode == "none":
            self._fail(WorkerCrashed(msg))
            return False
        t_detect = time.monotonic()
        if mode == "respawn":
            if self._respawns_used >= self.opts.max_respawns:
                self._fail(WorkerCrashed(
                    f"{msg}; respawn budget exhausted "
                    f"({self.opts.max_respawns})"))
                return False
            return self._respawn_worker(unfinished, msg, t_detect)
        if mode == "reissue":
            self._reissue_splinters(unfinished, t_detect)
            return True
        self._fail(WorkerCrashed(msg))     # unknown mode: behave as "none"
        return False

    def _respawn_worker(self, unfinished: List[Splinter], msg: str,
                        t_detect: float) -> bool:
        """Spawn a replacement process owning exactly the unfinished tail.

        The replacement attaches to the SAME session arena by name (which
        is why the arena unlink is deferred under this mode) and to a fresh
        ring segment of its own, then runs the normal go-gate protocol —
        its gate opens individually in _check_pending_attach. ``prefault``
        is off and ``stripe_bounds`` empty: re-touching pages that already
        hold read data would corrupt them.
        """
        self._respawns_used += 1
        rb = ring_bytes(self.opts.ring_slots)
        try:
            shm = SharedArena.create(rb, tag="ring-r")
        except OSError as e:
            self._fail(WorkerCrashed(f"{msg}; respawn failed: {e}"))
            return False
        new_w = len(self._procs)
        ring = EventRing(shm.buf[:rb], self.opts.ring_slots, create=True)
        spec = WorkerSpec(
            worker_id=new_w,
            file_path=self.file.path,
            arena_path=self._shm.path,
            arena_bytes=self.plan.nbytes,
            base_offset=self._base,
            ring_path=shm.path,
            ring_region_bytes=rb,
            ring_offset=0,
            ring_slots=self.opts.ring_slots,
            splinters=tuple(unfinished),
            stripe_bounds=(),
            prefault=False,
            pin_cpus=None,
            delay_model=self.opts.delay_model,
            fault=self.opts.worker_fault,
            io_fault=self.opts.io_fault,
            ring_fault=self.opts.ring_fault,
            parent_pid=os.getpid(),
            shards=getattr(self.file, "worker_segments", None),
            direct_io=self.opts.direct_io,
            queue_depth=self.opts.queue_depth,
            readahead_bytes=self.opts.readahead_bytes,
            submit_mode=self.opts.submit_mode,
        )
        p = WorkerProcess(spec, name=f"ckio-reader-r{new_w}")
        try:
            p.start()
            p.send()
        except BaseException as e:
            shm.close()
            self._fail(WorkerCrashed(f"{msg}; respawn failed: {e}"))
            return False
        self._rings.append(ring)
        self._procs.append(p)
        self._worker_splinters.append(tuple(unfinished))
        self._worker_retired.append(False)
        self._last_progress.append(time.monotonic())
        self._extra_ring_shms[new_w] = shm
        self._pending_attach[new_w] = (
            time.monotonic() + self.opts.worker_attach_timeout, t_detect)
        self.metrics.recovery.record_respawn(
            len(unfinished), sum(sp.nbytes for sp in unfinished),
            by_shard=self._shard_attribution(unfinished))
        return True

    def _check_pending_attach(self) -> bool:
        """Open the go-gate of each respawned worker as it attaches (its
        placement phase is empty — no collective barrier to wait for).
        Returns False only on a terminal attach timeout."""
        for w in list(self._pending_attach):
            attach_deadline, t_detect = self._pending_attach[w]
            if self._rings[w].state() == ST_INIT:
                if time.monotonic() > attach_deadline:
                    self._fail(WorkerCrashed(
                        f"respawned {self._worker_label(w)} failed to "
                        f"attach within {self.opts.worker_attach_timeout}s"))
                    return False
                continue
            # Attached (or already errored — the dead-child loop will see
            # ST_ERROR next iteration either way): open its private gate.
            self._rings[w].open_gate()
            shm = self._extra_ring_shms.get(w)
            if shm is not None:
                shm.unlink()
            self._last_progress[w] = time.monotonic()
            self.metrics.recovery.record_recovery_latency(
                time.monotonic() - t_detect)
            del self._pending_attach[w]
        return True

    def _reissue_splinters(self, unfinished: List[Splinter],
                           t_detect: float) -> None:
        """Re-read a dead worker's unfinished splinters supervisor-side.

        A surviving worker's splinter list is fixed at spawn (SPSC rings
        carry no work-push channel), so "reassign to surviving readers"
        means: an emergency reader thread in THIS process reads the tail
        through the parent's own fd straight into the mapped arena and
        re-enters _mark_done — every delivery invariant (waiters,
        subscriber order, arrival log, zero-copy views) holds because it
        is the same fan-out path, and ``bytes_copied`` stays 0 because the
        bytes land in the same shared pages workers write. Worker-side
        injection hooks (delay_model / worker_fault / io_fault) model the
        dead worker's environment and deliberately do NOT apply here."""
        self.metrics.recovery.record_reissue(
            len(unfinished), sum(sp.nbytes for sp in unfinished),
            by_shard=self._shard_attribution(unfinished))
        th = threading.Thread(
            target=self._reissue_main, args=(list(unfinished), t_detect),
            daemon=True, name="ckio-reissue")
        self._reissue_threads.append(th)
        th.start()

    def _reissue_main(self, splinters: List[Splinter],
                      t_detect: float) -> None:
        try:
            for sp in splinters:
                if self._cancelled or self.error is not None:
                    return
                t0 = time.perf_counter()
                lo = sp.offset - self._base
                view = memoryview(self._arena)[lo: lo + sp.nbytes]
                n = self.file.pread_into(sp.offset, view,
                                         stats=self.metrics.recovery)
                dt = time.perf_counter() - t0
                if n != sp.nbytes:
                    raise IOError(
                        f"short read re-issuing splinter {sp.index}: "
                        f"wanted {sp.nbytes} at {sp.offset}, got {n}")
                self.metrics.record_read(sp.reader, sp.nbytes, dt)
                if self._shard_of is not None:
                    self.metrics.record_shard_read(
                        self._shard_of(sp.offset), sp.nbytes)
                if self.opts.topology is not None:
                    self.locality.record_splinter(sp.reader, sp.nbytes)
                self._mark_done(sp)
            self.metrics.recovery.record_recovery_latency(
                time.monotonic() - t_detect)
        except BaseException as e:
            self._fail(WorkerCrashed(f"splinter re-issue failed: {e}"))

    def _watchdog_sweep(self) -> None:
        """SIGKILL any live worker that owns unfinished splinters but has
        published nothing for ``worker_watchdog_s`` — a hung pread (dying
        FS) or a stalled process. The dead-child loop then converts the
        kill into recovery (or a terminal failure under recovery="none",
        which still turns a silent hang into a descriptive error)."""
        wd = self.opts.worker_watchdog_s
        if wd <= 0:
            return
        now = time.monotonic()
        for w in range(len(self._procs)):
            if self._worker_retired[w] or w in self._pending_attach:
                continue
            p, ring = self._procs[w], self._rings[w]
            if ring.state() in (ST_DONE, ST_ERROR) or not p.is_alive():
                continue
            if now - self._last_progress[w] <= wd:
                continue
            if not self._unfinished(w):
                continue
            self.metrics.recovery.record_watchdog_kill()
            p.kill()
            p.join(5.0)

    def _shutdown_workers(self) -> None:
        """Graceful drain, then SIGKILL-on-timeout; releases ring mappings."""
        if self._workers_shutdown:
            return
        self._workers_shutdown = True
        rings, procs = self._rings, self._procs
        for ring in rings:
            ring.request_stop()
        deadline = time.monotonic() + self.opts.worker_stop_timeout
        # ``p.pid is None`` = never started (spawn aborted mid-loop) —
        # join/kill on those raise instead of no-op'ing.
        for p in procs:
            if p.pid is not None:
                p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.kill()
                p.join(5.0)
        # Emergency re-issue readers exit between splinters once cancel or
        # completion lands; join them before the arena mapping goes away.
        for th in self._reissue_threads:
            if th.is_alive():
                th.join(5.0)
        # Fold each worker's transient-I/O counters (ring header words) and
        # each finished worker's report (submit backend, in-flight high-water
        # mark, direct tails) into the session's metrics — exactly once,
        # guarded by _workers_shutdown above.
        kinds, boot, imports = set(), [0.0], [0.0]
        for ring, p in zip(rings, procs):
            r, s = ring.io_report()
            rep = ring.report() if ring.state() == ST_DONE else {}
            tails, tail_bytes = (int(rep.get("tails", 0)),
                                 int(rep.get("tail_bytes", 0)))
            if r or s or tails:
                self.metrics.recovery.add_worker_io(r, s, tails, tail_bytes)
            if "submit" in rep:
                kinds.add(rep["submit"])
                self.metrics.record_inflight_hwm(int(rep["hwm"]))
            if "t_boot" in rep:
                boot.append(float(rep["t_boot"]) - p.t_start)
                imports.append(float(rep["t_ready"]) - float(rep["t_boot"]))
        with self.metrics.lock:
            if kinds:
                self.metrics.submit_backend = "+".join(sorted(kinds))
            self.metrics.worker_boot_s = max(boot)
            self.metrics.worker_import_s = max(imports)
        # Workers are gone: the names can't be needed again. Unlink here
        # too (idempotent) so a session that failed before the gate opened
        # still leaves nothing behind in /dev/shm. Under recovery="respawn"
        # this is where the deferred arena unlink happens.
        if self._shm is not None:
            self._shm.unlink()
        # Drop the parent-side ring views before closing their mapping (a
        # live export pins it — close() tolerates stragglers either way).
        self._rings = []
        del rings
        if self._rings_shm is not None:
            self._rings_shm.close()
            self._rings_shm = None
        for shm in self._extra_ring_shms.values():
            shm.close()                # idempotent unlink + unmap
        self._extra_ring_shms = {}
