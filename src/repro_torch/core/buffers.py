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

This copy carries the default thread backend only: helper I/O threads in
this process reading into a pageable ``np.empty`` arena, buffered or
``O_DIRECT`` (the arena then sits on the file's block grid), either one
blocking read per splinter or ``queue_depth`` reads in flight through
``io/submit.py``. The process backend and NUMA placement are later slices
of the port.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.metrics import SessionMetrics
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.io.layout import StripePlan, Splinter, splinters_covering
from repro_torch.io.posix import DEFAULT_ALIGN, DirectIOError, PosixFile
from repro_torch.io.submit import AsyncReadEngine, ring_selected


@dataclass
class ReaderOptions:
    """Tunables for the reader layer (the knobs the paper exposes + §VI)."""

    splinter_bytes: int = 8 * 1024 * 1024
    work_stealing: bool = True
    max_io_threads: int = 64
    # Fault-injection hook (plugs into PosixFile.pread_into: short reads /
    # transient OSErrors).
    io_fault: Optional[object] = None
    # test/bench hook: seconds of injected delay before reading a splinter
    delay_model: Optional[Callable[[int, Splinter], float]] = None
    # optional cross-node transfer model (None = immediate hand-off)
    network: Optional["NetworkModel"] = None
    # per-piece delivery timing sample rate (0 = off; N = every Nth piece)
    piece_timing_every: int = 0
    # Zero-fill the arena up front (a full memset on the start critical
    # path — the legacy "before" of the non-zero-filled np.empty arena).
    prefault_arena: bool = False
    # -- cold-cache read engine (io/submit.py) -------------------------------
    # The file handle was opened O_DIRECT (reads DMA past the page cache).
    # start() validates the arena/plan against the probed block size and
    # raises io.posix.DirectIOError on any structural misalignment.
    direct_io: bool = False
    # In-flight reads per reader thread: 0/1 = the blocking per-splinter
    # loop; >= 2 = depth-managed async submission (io_uring or a preadv
    # pool, see submit_mode).
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

        # FileSet sessions: the handle resolves offsets to shard ids
        # (io.posix.ShardedFile.shard_of); None for single-file sessions.
        # Splinters never span shards (hard stripe bounds), so attributing
        # a whole pread to shard_of(offset) is exact.
        self._shard_of = getattr(file, "shard_of", None)
        # Session storage: stripes are slices of one arena. Readers fill it;
        # clients get zero-copy memoryviews out of it.
        self._arena: np.ndarray = self._alloc_arena(plan)
        self._base = plan.offset

        self._lock = threading.Lock()
        self._done = [False] * len(plan.splinters)
        self._ndone = 0
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
        self._cancelled = False
        self._complete_evt = threading.Event()
        if not plan.splinters:
            self._complete_evt.set()
        self.started = False
        # Borrowed read-only views handed to zero-copy clients; released
        # (invalidated) when the session closes. _pinned_borrows counts the
        # ones a live buffer export kept alive through invalidation.
        self._borrows: List[memoryview] = []
        self._pinned_borrows = 0

    def _alloc_arena(self, plan: StripePlan) -> np.ndarray:
        """Allocate the session arena. np.empty skips the memset a
        bytearray would do — every byte is overwritten by preadv anyway,
        and for multi-GB sessions the zero-fill pass dominated session
        start (it sat on the critical path of the first request).

        The arena is pageable host memory: a host→device copy from it is
        synchronous with respect to the source (the copy returns once the
        bytes have been consumed), which is what lets the pipeline release
        a session right after staging its window."""
        if getattr(self.file, "direct_io", False):
            # O_DIRECT DMA targets need the arena base on the FS block grid,
            # but numpy only guarantees 16-byte alignment for small
            # allocations: over-allocate one block and slice to the grid
            # (the parent buffer stays alive through ``.base``).
            bs = getattr(self.file, "block_size", DEFAULT_ALIGN)
            raw = np.empty(plan.nbytes + bs, dtype=np.uint8)
            skew = (-raw.ctypes.data) % bs
            arena = raw[skew: skew + plan.nbytes]
        else:
            arena = np.empty(plan.nbytes, dtype=np.uint8)
        if self.opts.prefault_arena:
            # Legacy prefault — explicit memset: np.zeros would calloc
            # lazily-zeroed pages without touching them — fill() actually
            # faults every page in.
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
        nthreads = min(
            max(1, self.plan.num_readers), max(1, self.opts.max_io_threads)
        )
        if self.opts.queue_depth >= 2:
            # Each reader thread builds its own engine; a forced io_uring
            # that cannot run (a sharded file, a kernel that refuses the
            # ring) fails the session start here, not a reader thread.
            ring_selected(self.file, self.opts.submit_mode,
                          self.opts.delay_model)
        self.started = True
        # Recorded here (not only in the async loop) so blocking-path
        # sessions still report their open mode.
        self.metrics.direct_io = bool(getattr(self.file, "direct_io", False))
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
            if self.opts.work_stealing:
                victim = max(
                    range(self.plan.num_readers),
                    key=lambda r: len(self._pending[r]),
                    default=None,
                )
                if victim is not None and self._pending[victim]:
                    self.metrics.record_steal(victim)
                    return self._pending[victim].pop()  # steal from the tail
        return None

    def _reader_main(self, tid: int, nthreads: int) -> None:
        if self.opts.queue_depth >= 2:
            self._reader_main_async(tid, nthreads)
            return
        while not self._cancelled:
            sp = self._next_splinter(tid, nthreads)
            if sp is None:
                return                # own stripes drained; nothing to steal
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
            self._mark_done(sp)

    def _reader_main_async(self, tid: int, nthreads: int) -> None:
        """Depth-managed drain: same work source (``_next_splinter`` — so
        stealing survives), same completion fan-out (``_mark_done``, which
        also feeds the splinter stream of a streamed pipeline), but up to
        ``queue_depth`` splinter reads in flight through ``io/submit.py``
        instead of one blocking pread at a time."""
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
            if self._cancelled:
                return None
            sp = self._next_splinter(tid, nthreads)
            if sp is None:
                return None           # own stripes drained; nothing to steal
            lo = sp.offset - self._base
            return (sp, sp.offset, memoryview(self._arena)[lo: lo + sp.nbytes])

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
            self._mark_done(sp)

        try:
            eng.run(next_item, on_complete, stop=lambda: self._cancelled)
        finally:
            self.metrics.record_inflight_hwm(eng.max_inflight)

    def _mark_done(self, sp: Splinter) -> None:
        """Record one splinter completion and fan out waiters/subscribers."""
        to_fire: List[Callable[[], None]] = []
        ev = SplinterEvent(
            index=sp.index,
            reader=sp.reader,
            offset=sp.offset,
            nbytes=sp.nbytes,
            arena_off=sp.offset - self._base,
            t_arrival=time.perf_counter(),
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
    ) -> None:
        """Invoke ``fire`` once every byte of the range is resident.

        Thread-safe. ``fire`` must be cheap (it enqueues a scheduler task).
        If the data is already resident the callback runs immediately in the
        caller — the paper's "request buffered until the I/O is finished"
        semantics, with the buffered case handled by the waiter table.
        """
        need = [
            s.index
            for s in splinters_covering(self.plan, abs_off, nbytes)
        ]
        with self._lock:
            missing = [i for i in need if not self._done[i]]
            if missing:
                w = _Waiter(remaining=len(missing), fire=fire)
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

    def reader_pe(self, r: int) -> int:
        return self.reader_pes[r]

    def reader_node(self, r: int) -> int:
        return self.sched.node_of(self.reader_pes[r])

    def reader_locality(self, r: int) -> int:
        """Scheduler node of reader ``r`` — the piece-coalescing key (one
        memory domain per node in this slice)."""
        return self.sched.node_of(self.reader_pes[r])
