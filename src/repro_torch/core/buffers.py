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
this process, buffered ``preadv`` into a pageable ``np.empty`` arena, one
blocking read per splinter. The process backend, NUMA placement, direct
I/O and queue-depth submission are later slices of the port.
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
from repro_torch.io.posix import PosixFile


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
        arena = np.empty(plan.nbytes, dtype=np.uint8)
        if self.opts.prefault_arena:
            # Legacy prefault — explicit memset: np.zeros would calloc
            # lazily-zeroed pages without touching them — fill() actually
            # faults every page in.
            arena.fill(0)
        return arena

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Begin greedy prefetch: every reader starts reading immediately
        (paper Fig. 5: "Buffer Chares begin reading on session instantiation,
        without waiting for client requests")."""
        if self.started:
            return
        self.started = True
        nthreads = min(
            max(1, self.plan.num_readers), max(1, self.opts.max_io_threads)
        )
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
            self._mark_done(sp)

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
