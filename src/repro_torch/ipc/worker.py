"""Reader worker process: the paper's buffer chare as a real OS process.

``worker_main`` is the entry point of one reader worker of a
``backend="process"`` session (``core/buffers.py`` ``ProcessReaderSet`` is
the supervisor). Everything a worker needs travels in a picklable
:class:`WorkerSpec`; nothing relies on fd or state inheritance:

1. **attach**: map the worker's event ring and the session arena *by name*
   (each process opens and immediately closes its own fds).
2. **place**: optionally ``sched_setaffinity``-pin the whole process to its
   stripe's NUMA-domain CPUs, then first-touch-fault the pages of every
   stripe it owns (one byte per page) — under Linux first-touch this is
   what makes domain striping span *real* CPU sets across processes.
   Outcomes (pages, pin) are reported through the ring header.
3. **barrier**: report ``ATTACHED`` and park until the supervisor opens the
   ``go`` gate (all workers placed — stripe placement is complete before
   any read) or requests a stop (session cancelled during spawn).
4. **drain**: open an **own** descriptor on the data file (``PosixFile``),
   or one per shard (``ShardedFile.from_segments``) for a FileSet session,
   read each owned splinter with ``preadv`` straight into the shared arena
   (zero copies in this process too) and publish one ring event per
   completion. At ``queue_depth >= 2`` the drain keeps that many reads in
   flight through ``io/submit.py`` (:func:`_drain_async`). A stop request
   between splinters exits the loop — the graceful-drain half of the
   supervisor's stop/SIGKILL protocol.
5. **exit**: write the report (submit backend, in-flight high-water mark,
   direct tails) into the ring's message area, report ``DONE`` and return.
   Any exception lands in the ring's error area as ``ERROR`` + message (the
   supervisor surfaces it verbatim); a hard crash (``os._exit``, SIGKILL,
   SIGBUS of a full ``/dev/shm``) leaves the state below ``DONE``, which
   the supervisor's dead-child check converts into a descriptive session
   error instead of a hang.

**How a worker starts.** :class:`WorkerProcess` runs a fresh interpreter
(``sys.executable -c``) that imports this module alone and reads its
pickled spec from stdin — never a fork, since the parent may hold a CUDA
context and threads. ``multiprocessing``'s spawn method would re-import the
parent's ``__main__`` in every child; under ``python -m
repro_torch.launch.train`` that imports torch and the models, seconds a
worker and a session per step. This module and what it imports
(``repro_torch.io``, ``repro_torch.ipc``, numpy) load no torch.

Test hooks (picklable): :class:`StallReader` delays a chosen reader (also a
thread-backend ``delay_model``); :class:`ExitAfter` hard-kills the worker
mid-session (crash-path tests); :class:`RaiseAfter` exercises the ERROR
reporting path. ``core/faults.py`` re-exports them. The reader service's
pooled workers come with that slice.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.io.layout import Splinter
from repro_torch.io.numa import first_touch, pin_thread_to_cpus
from repro_torch.io.posix import PosixFile, ShardedFile
from repro_torch.io.submit import AsyncReadEngine
from repro_torch.ipc.ring import (
    PIN_FAILED,
    PIN_NONE,
    PIN_OK,
    ST_ATTACHED,
    ST_DONE,
    EventRing,
    RingEvent,
    ring_bytes,
)
from repro_torch.ipc.shm import SharedArena


class WorkerCrashed(RuntimeError):
    """A reader worker process died (or errored) before finishing its
    stripe; the owning session is failed fast with this error."""


@dataclass
class WorkerSpec:
    """Everything one worker needs, shipped pickled to the new process."""

    worker_id: int
    file_path: str                       # data file — worker opens OWN fd
    arena_path: str                      # session arena shm segment name
    arena_bytes: int
    base_offset: int                     # plan.offset (arena[0] ≡ this)
    ring_path: str                       # ring-block shm segment name
    ring_region_bytes: int
    ring_offset: int                     # this worker's ring within the block
    ring_slots: int
    splinters: Tuple[Splinter, ...]      # owned splinters, stripe order
    stripe_bounds: Tuple[Tuple[int, int], ...]   # owned stripes (abs bounds)
    prefault: bool = False               # first-touch owned stripes
    pin_cpus: Optional[Tuple[int, ...]] = None   # sched_setaffinity target
    delay_model: Optional[object] = None  # picklable (reader, Splinter)->s
    fault: Optional[object] = None        # picklable (reader, index)->None
    # Fault-injection hooks for the lower layers (picklable, core/faults.py):
    # io_fault plugs into PosixFile.pread_into (short reads / transient
    # OSErrors), ring_fault into EventRing.publish (torn slot stamps).
    io_fault: Optional[object] = None
    ring_fault: Optional[object] = None
    # Supervisor's pid: the orphan guard. 0 disables (inline test runs).
    # A worker whose parent vanishes (SIGKILL/OOM of the consumer process)
    # must not keep polling a ring nobody will ever drain while pinning the
    # session-sized arena mapping in tmpfs.
    parent_pid: int = 0
    # FileSet sessions: the ShardedFile segment table — (path, global_start,
    # file_base, nbytes, shard_id) per non-empty shard. The worker rebuilds
    # its OWN ShardedFile from these paths (one fresh fd per shard, nothing
    # inherited); splinter offsets are then global data-space bytes. None =
    # single-file session.
    shards: Optional[Tuple[Tuple[str, int, int, int, int], ...]] = None
    # Cold-cache read engine (io/submit.py): the worker opens its own fds
    # with O_DIRECT when direct_io, and drains with queue_depth reads in
    # flight (0/1 = the blocking loop) through submit_mode, advising
    # readahead_bytes ahead of the submission frontier.
    direct_io: bool = False
    queue_depth: int = 0
    readahead_bytes: int = 0
    submit_mode: str = "auto"
    # Stamped into every published event. Per-session workers leave it 0;
    # the reader service's pooled workers number their sessions with it.
    epoch: int = 0


def _make_orphan_guard(parent_pid: int):
    """getppid-polling supervisor-death check (see worker_main notes)."""
    if parent_pid:
        return lambda: os.getppid() != parent_pid
    return lambda: False


def _run_session(spec: WorkerSpec, ring: EventRing, io: "_IOCounters",
                 orphaned) -> None:
    """One session's worth of the worker protocol: place → attach arena →
    barrier → drain; the caller owns state/error reporting. The arena
    mapping is detached (never unlinked) on the way out."""
    pin = PIN_NONE
    if spec.pin_cpus:
        # Whole-process affinity: unlike the thread backend's per-thread
        # re-pinning, one worker process has one CPU set — its primary
        # stripe's domain (workers owning stripes in several domains
        # keep the first; first-touch still runs per stripe).
        pin = PIN_OK if pin_thread_to_cpus(spec.pin_cpus) else PIN_FAILED
    arena = SharedArena.attach(spec.arena_path, spec.arena_bytes)
    try:
        arr = arena.ndarray()
        pages = 0
        if spec.prefault:
            for lo, hi in spec.stripe_bounds:
                if hi > lo:
                    pages += first_touch(
                        arr[lo - spec.base_offset: hi - spec.base_offset])
        ring.set_touch(pages, pin)
        ring.set_state(ST_ATTACHED)
        if not ring.wait_go(should_abort=orphaned):   # cancelled / orphaned
            return
        if spec.shards is not None:          # FileSet: own fd per shard
            f = ShardedFile.from_segments(spec.shards,
                                          direct_io=spec.direct_io)
        else:                                # own fd — never inherited
            f = PosixFile.open(spec.file_path, direct_io=spec.direct_io)
        f.fault = spec.io_fault
        try:
            if spec.queue_depth >= 2:        # depth-managed async drain
                _drain_async(spec, f, arr, ring, io, orphaned)
                return
            for sp in spec.splinters:
                if ring.stop_requested():    # graceful drain request
                    break
                if orphaned():               # nobody left to drain events
                    break
                if spec.delay_model is not None:
                    d = spec.delay_model(sp.reader, sp)
                    if d > 0:
                        time.sleep(d)
                if spec.fault is not None:
                    spec.fault(sp.reader, sp.index)
                t0 = time.perf_counter()
                lo = sp.offset - spec.base_offset
                view = memoryview(arr)[lo: lo + sp.nbytes]
                n = f.pread_into(sp.offset, view, stats=io)
                dt = time.perf_counter() - t0
                view = None
                if n != sp.nbytes:
                    raise IOError(
                        f"short read: wanted {sp.nbytes} at {sp.offset}, "
                        f"got {n}")
                # Refresh the header counters per splinter (not just at
                # exit) so a later crash still leaves the latest tallies
                # for the parent's fold-in.
                ring.set_io(io.retries, io.suppressed)
                published = ring.publish(RingEvent(
                    index=sp.index, reader=sp.reader, offset=sp.offset,
                    nbytes=sp.nbytes, arena_off=lo,
                    t_arrival=time.perf_counter(), read_dt=dt,
                    epoch=spec.epoch,
                ), should_abort=orphaned)
                if not published:            # stop/orphan won the backoff
                    break
        finally:
            f.close()
    finally:
        # Drop the np export before detaching so the mapping is actually
        # released here, not lazily at the next GC.
        arr = None                           # noqa: F841
        arena.detach()


def worker_main(spec: WorkerSpec,
                boot: Optional[Tuple[float, float]] = None) -> None:
    """Worker entry point (see module docstring for the protocol).
    ``boot`` is the ``perf_counter`` at the new interpreter's first line
    and after its imports and spec (``_child_main``); the report carries
    both, so the supervisor can split its spawn → attached time."""
    # Orphan guard: polled between splinters and inside every backoff loop
    # (wait_go, full-ring publish). getppid() tracks the supervisor
    # *process*, whichever of its threads started this worker.
    orphaned = _make_orphan_guard(spec.parent_pid)
    if spec.parent_pid and orphaned():       # parent died during spawn
        return
    rings = SharedArena.attach(spec.ring_path, spec.ring_region_bytes)
    ring = EventRing(
        rings.buf[spec.ring_offset:
                  spec.ring_offset + ring_bytes(spec.ring_slots)],
        spec.ring_slots,
    )
    ring.set_pid(os.getpid())
    ring.fault = spec.ring_fault
    io = _IOCounters()
    try:
        _run_session(spec, ring, io, orphaned)
        ring.set_io(io.retries, io.suppressed)
        report = io.report()
        if boot is not None:
            report.update(t_boot=f"{boot[0]:.6f}", t_ready=f"{boot[1]:.6f}")
        ring.set_report(report)
        ring.set_state(ST_DONE)
    except BaseException as e:
        ring.set_io(io.retries, io.suppressed)
        ring.set_error(f"{type(e).__name__}: {e}")
        raise SystemExit(1)


def _drain_async(spec: WorkerSpec, f, arr, ring: EventRing,
                 io: "_IOCounters", orphaned) -> None:
    """Depth-managed drain (``queue_depth >= 2``): the worker-process twin
    of the thread backend's async reader loop. Splinters are submitted
    through :class:`AsyncReadEngine` (io_uring or the preadv pool) with up
    to ``spec.queue_depth`` in flight; completions publish the same ring
    events as the blocking loop, in completion (not stripe) order — the
    supervisor's ``_mark_done`` fan-out is order-agnostic. A stop request,
    orphaning, or a full-ring publish loss flips ``stopped`` so the engine
    drains what is in flight without submitting more. The engine's backend
    and in-flight high-water mark go into the worker's report."""
    base = spec.base_offset
    it = iter(spec.splinters)
    stopped = [False]

    def stop() -> bool:
        return stopped[0]

    def next_item():
        if stopped[0] or ring.stop_requested() or orphaned():
            stopped[0] = True
            return None
        sp = next(it, None)
        if sp is None:
            return None
        if spec.fault is not None:           # crash/raise hook at submission
            spec.fault(sp.reader, sp.index)
        lo = sp.offset - base
        return sp, sp.offset, memoryview(arr)[lo: lo + sp.nbytes]

    delay = None
    if spec.delay_model is not None:
        dm = spec.delay_model

        def delay(sp, nbytes):               # runs on the submitter's clock
            d = dm(sp.reader, sp)
            if d > 0:
                time.sleep(d)

    eng = AsyncReadEngine(
        f, spec.queue_depth, readahead_bytes=spec.readahead_bytes,
        mode=spec.submit_mode, stats=io, fault=spec.io_fault, delay=delay)
    io.submit = eng.kind

    def on_complete(sp: Splinter, n: int, dt: float) -> None:
        if n != sp.nbytes:
            raise IOError(
                f"short read: wanted {sp.nbytes} at {sp.offset}, got {n}")
        io.hwm = max(io.hwm, eng.max_inflight)
        # Refresh the header counters per splinter (crash-tolerant tallies,
        # same contract as the blocking loop).
        ring.set_io(io.retries, io.suppressed)
        published = ring.publish(RingEvent(
            index=sp.index, reader=sp.reader, offset=sp.offset,
            nbytes=sp.nbytes, arena_off=sp.offset - base,
            t_arrival=time.perf_counter(), read_dt=dt,
            epoch=spec.epoch,
        ), should_abort=orphaned)
        if not published:                    # stop/orphan won the backoff
            stopped[0] = True

    try:
        eng.run(next_item, on_complete, stop=stop)
    finally:
        io.hwm = max(io.hwm, eng.max_inflight)


class _IOCounters:
    """Worker-local sink for the posix retry layer's stats protocol. The
    retry tallies travel to the parent through the ring header
    (``set_io``); the submit backend, the in-flight high-water mark and the
    direct tails through the worker's report (``set_report``)."""

    __slots__ = ("retries", "suppressed", "tails", "tail_bytes", "submit",
                 "hwm")

    def __init__(self) -> None:
        self.retries = 0
        self.suppressed = 0
        self.tails = 0
        self.tail_bytes = 0
        self.submit = ""
        self.hwm = 0

    def record_io_retry(self, err: Optional[int] = None) -> None:
        self.retries += 1

    def record_suppressed(self, err: Optional[int] = None) -> None:
        self.suppressed += 1

    def record_direct_tail(self, nbytes: int = 0) -> None:
        self.tails += 1
        self.tail_bytes += int(nbytes)

    def report(self) -> Dict[str, object]:
        out: Dict[str, object] = {"tails": self.tails,
                                  "tail_bytes": self.tail_bytes}
        if self.submit:
            out.update(submit=self.submit, hwm=self.hwm)
        return out


# -- starting a worker -----------------------------------------------------------
_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CHILD = ("import time; t_boot = time.perf_counter(); "
          "from repro_torch.ipc.worker import _child_main; "
          "_child_main(t_boot)")


def _child_main(t_boot: float) -> None:
    """The new interpreter's entry: read the pickled spec from stdin (bytes
    the supervisor wrote) and run :func:`worker_main`."""
    spec = pickle.load(sys.stdin.buffer)
    sys.stdin.close()
    worker_main(spec, boot=(t_boot, time.perf_counter()))


class WorkerProcess:
    """A reader worker run as a fresh interpreter (see module docstring),
    with the part of ``multiprocessing.Process`` the supervisor uses:
    ``start``, ``pid``, ``is_alive``, ``exitcode`` (negative: killed by that
    signal), ``join`` and ``kill``.

    The spec is pickled at construction, so an unpicklable hook fails
    before any process exists; ``send`` writes it to the child's stdin
    after ``start``. The supervisor starts every worker of a session before
    it sends any spec, so the interpreters start side by side."""

    def __init__(self, spec: WorkerSpec, name: str = ""):
        self.spec = spec
        self.name = name
        self._payload: Optional[bytes] = pickle.dumps(spec)
        self._p: Optional[subprocess.Popen] = None
        self.t_start = 0.0               # perf_counter just before the exec

    def start(self) -> None:
        self.t_start = time.perf_counter()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC_ROOT, env.get("PYTHONPATH", "")) if p)
        self._p = subprocess.Popen([sys.executable, "-c", _CHILD],
                                   stdin=subprocess.PIPE, env=env)

    def send(self) -> None:
        """Write the spec to the child (once). A child that died before it
        read it shows up in ``exitcode``; the pipe error is not raised."""
        p, payload, self._payload = self._p, self._payload, None
        if p is None or payload is None:
            return
        try:
            p.stdin.write(payload)
            p.stdin.close()
        except (BrokenPipeError, OSError):
            pass

    @property
    def pid(self) -> Optional[int]:
        return None if self._p is None else self._p.pid

    def is_alive(self) -> bool:
        return self._p is not None and self._p.poll() is None

    @property
    def exitcode(self) -> Optional[int]:
        return None if self._p is None else self._p.poll()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._p is None:
            return
        try:
            self._p.wait(timeout)
        except subprocess.TimeoutExpired:
            pass

    def kill(self) -> None:
        if self.is_alive():
            self._p.kill()


# -- picklable test/bench hooks ----------------------------------------------
@dataclass
class StallReader:
    """``delay_model``: delay every splinter of ``reader`` by ``seconds``
    (the straggler injector, picklable for a worker process)."""

    reader: int
    seconds: float

    def __call__(self, reader: int, sp: Splinter) -> float:
        return self.seconds if reader == self.reader else 0.0


@dataclass
class ExitAfter:
    """Hard-crash fault hook: ``os._exit(code)`` before reading the
    (``after``+1)-th splinter — no ERROR state, no cleanup, exactly what a
    segfault/OOM-kill looks like to the supervisor."""

    after: int
    code: int = 42

    def __call__(self, reader: int, index: int) -> None:
        self.after -= 1
        if self.after < 0:
            os._exit(self.code)


@dataclass
class RaiseAfter:
    """Soft-failure fault hook: raise before reading the (``after``+1)-th
    splinter — exercises the worker's ERROR-state reporting path."""

    after: int
    message: str = "injected worker fault"

    def __call__(self, reader: int, index: int) -> None:
        self.after -= 1
        if self.after < 0:
            raise RuntimeError(self.message)
