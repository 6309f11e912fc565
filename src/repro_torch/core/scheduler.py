"""Cooperative task scheduler — the Charm++ RTS analog.

Charm++ schedules asynchronous method invocations on per-PE user-space
queues; no task may block its PE. We reproduce that execution model with
logical PEs hosted in one process: tasks are run-to-completion callables
bound to a PE, executed cooperatively by whichever thread pumps the
scheduler, while *I/O helper threads* (the paper's per-buffer-chare
pthreads) enqueue completion tasks from outside.

Properties preserved from the paper's model (and tested):
  * split-phase: an I/O call never executes user continuations inline; it
    only enqueues them (paper §III-D: "the system only enqueues the
    corresponding method invocation as a task").
  * message-driven: no ordering guarantee between tasks on different PEs;
    round-robin draining gives fair interleave of I/O completions and
    background work.
  * quiescence: ``run_until`` parks on a condition variable when all queues
    are empty, to be woken by I/O threads — the "PE" is idle but never
    spinning inside a read.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple


@dataclass
class _Task:
    pe: int
    fn: Callable[..., Any]
    args: tuple
    label: str = ""


class QuiescenceTimeout(RuntimeError):
    pass


class TaskScheduler:
    """Per-PE task queues + cooperative pump.

    ``num_pes`` is the number of *logical* processors ("PEs"). This container
    has one physical core; logical PEs model placement (which node/PE a chare
    lives on) exactly as the paper's experiments vary nodes×PEs.
    """

    def __init__(self, num_pes: int = 1, pes_per_node: int = 1):
        if num_pes < 1:
            raise ValueError("num_pes must be >= 1")
        self.num_pes = num_pes
        self.pes_per_node = max(1, pes_per_node)
        self._queues: List[Deque[_Task]] = [deque() for _ in range(num_pes)]
        self._cv = threading.Condition()
        self._pending = 0           # tasks enqueued but not yet executed
        self._executed = 0
        # Seconds pumping threads spent parked on ``_cv`` in ``run_until``
        # and ``pump_until_deadline`` (waiting for I/O threads), cumulative.
        self.parked_s = 0.0
        # O(1) dispatch: deque of PEs with non-empty queues (round-robin by
        # rotation) + membership flags, instead of scanning all num_pes
        # queues per pop — per-task dispatch cost no longer grows with the
        # PE count (TASIO: runtime overhead per completion bounds task-based
        # I/O at scale).
        self._ready: Deque[int] = deque()
        self._in_ready: List[bool] = [False] * num_pes
        self._tl = threading.local()   # per-thread enqueue batch buffer
        self.stats: Dict[str, int] = {"enqueued": 0, "executed": 0}

    # -- topology -----------------------------------------------------------
    def node_of(self, pe: int) -> int:
        return pe // self.pes_per_node

    @property
    def num_nodes(self) -> int:
        return (self.num_pes + self.pes_per_node - 1) // self.pes_per_node

    # -- enqueue (thread-safe; callable from I/O helper threads) -------------
    def _push_locked(self, t: _Task) -> None:
        """Append a task; caller holds ``self._cv``."""
        self._queues[t.pe].append(t)
        if not self._in_ready[t.pe]:
            self._in_ready[t.pe] = True
            self._ready.append(t.pe)
        self._pending += 1
        self.stats["enqueued"] += 1

    def enqueue(self, pe: int, fn: Callable[..., Any], *args: Any,
                label: str = "") -> None:
        if not (0 <= pe < self.num_pes):
            raise ValueError(f"PE {pe} out of range [0,{self.num_pes})")
        t = _Task(pe, fn, args, label)
        buf = getattr(self._tl, "buf", None)
        if buf is not None:          # inside batch(): defer lock + notify
            buf.append(t)
            return
        with self._cv:
            self._push_locked(t)
            # Exactly one pumper consumes a given task; waking every parked
            # thread per enqueue (notify_all) is pure overhead on the hot
            # completion path.
            self._cv.notify()

    def enqueue_many(
        self, tasks: Iterable[Tuple[int, Callable[..., Any]]], label: str = ""
    ) -> int:
        """Enqueue a batch of ``(pe, fn)`` or ``(pe, fn, args)`` tasks with a
        single lock acquisition and a single wake-up — one completion batch
        (e.g. a splinter landing and releasing many waiters, or a session
        broadcast to every PE) costs one synchronization, not one per task."""
        staged = []
        for item in tasks:
            pe, fn = item[0], item[1]
            args = item[2] if len(item) > 2 else ()
            if not (0 <= pe < self.num_pes):
                raise ValueError(f"PE {pe} out of range [0,{self.num_pes})")
            staged.append(_Task(pe, fn, tuple(args), label))
        if not staged:
            return 0
        buf = getattr(self._tl, "buf", None)
        if buf is not None:
            buf.extend(staged)
            return len(staged)
        self._flush(staged)
        return len(staged)

    def _flush(self, staged: List[_Task]) -> None:
        """Push a staged batch: one lock acquisition, one wake-up round."""
        with self._cv:
            for t in staged:
                self._push_locked(t)
            self._cv.notify(len(staged))

    @contextmanager
    def batch(self):
        """Context manager deferring ``enqueue`` calls made by this thread
        into one ``enqueue_many`` flush on exit (nesting flushes once, at the
        outermost level). Lets completion fan-out — N waiters fired by one
        splinter — take the scheduler lock once."""
        if getattr(self._tl, "buf", None) is not None:
            yield                    # already batching (nested)
            return
        self._tl.buf = []
        try:
            yield
        finally:
            staged, self._tl.buf = self._tl.buf, None
            if staged:
                self._flush(staged)

    def _park(self, seconds: float) -> None:
        """Wait on ``_cv`` (caller holds it) and count the time parked."""
        t = time.perf_counter()
        self._cv.wait(seconds)
        self.parked_s += time.perf_counter() - t

    # -- pump ----------------------------------------------------------------
    def _pop_next(self) -> Optional[_Task]:
        with self._cv:
            while self._ready:
                pe = self._ready.popleft()
                q = self._queues[pe]
                if not q:            # pragma: no cover - defensive
                    self._in_ready[pe] = False
                    continue
                t = q.popleft()
                if q:
                    self._ready.append(pe)   # rotate: fair round-robin
                else:
                    self._in_ready[pe] = False
                self._pending -= 1
                return t
        return None

    def step(self) -> bool:
        """Execute at most one task. Returns False if all queues were empty."""
        t = self._pop_next()
        if t is None:
            return False
        t.fn(*t.args)
        with self._cv:
            self._executed += 1
            self.stats["executed"] += 1
        return True

    def pump(self, max_tasks: Optional[int] = None) -> int:
        """Drain ready tasks (without waiting). Returns #tasks executed."""
        n = 0
        while (max_tasks is None or n < max_tasks) and self.step():
            n += 1
        return n

    def run_until(self, predicate: Callable[[], bool], *,
                  timeout: float = 60.0) -> None:
        """Pump tasks until ``predicate()`` holds.

        When no task is ready and the predicate is still false, park on the
        condition variable — I/O helper threads wake us by enqueueing
        completions. Raises ``QuiescenceTimeout`` on deadline.
        """
        deadline = time.monotonic() + timeout
        while not predicate():
            if self.step():
                continue
            with self._cv:
                if self._pending == 0 and not predicate():
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise QuiescenceTimeout(
                            f"predicate still false after {timeout}s "
                            f"(executed={self._executed})"
                        )
                    self._park(min(remaining, 0.1))
            if time.monotonic() > deadline:
                raise QuiescenceTimeout(
                    f"predicate still false after {timeout}s "
                    f"(executed={self._executed})"
                )

    def pump_until_deadline(self, deadline: float) -> int:
        """Process tasks until ``time.monotonic() >= deadline`` — the
        Charm++ idle loop: a PE waiting on an external event (the device
        step) keeps executing ready tasks (prefetch I/O completions)."""
        n = 0
        while True:
            now = time.monotonic()
            if now >= deadline:
                return n
            if self.step():
                n += 1
                continue
            with self._cv:
                if self._pending == 0:
                    self._park(min(deadline - now, 0.005))

    def run_to_quiescence(self, *, timeout: float = 60.0,
                          settle: float = 0.0) -> int:
        """Pump until all queues are empty (and stay empty for ``settle`` s)."""
        start = self._executed
        deadline = time.monotonic() + timeout
        while True:
            self.pump()
            with self._cv:
                if self._pending == 0:
                    if settle <= 0:
                        return self._executed - start
                    woken = self._cv.wait(settle)
                    if not woken and self._pending == 0:
                        return self._executed - start
            if time.monotonic() > deadline:
                raise QuiescenceTimeout(f"not quiescent after {timeout}s")


class BackgroundWorker:
    """A self-re-enqueueing chare for compute/I/O overlap (paper Figs. 8–9).

    Each invocation performs ~``grain_us`` microseconds of host compute, then
    *yields to the scheduler* by re-enqueueing itself — exactly the paper's
    benchmark structure ("at the end of every iteration, each chare yields
    control to the Charm scheduler").
    """

    def __init__(self, sched: TaskScheduler, pe: int, grain_us: float = 10.0):
        self.sched = sched
        self.pe = pe
        self.grain_us = grain_us
        self.iterations = 0
        self.busy_s = 0.0
        self.stopped = False

    def start(self) -> None:
        self.sched.enqueue(self.pe, self._iter, label="bg")

    def stop(self) -> None:
        self.stopped = True

    def _iter(self) -> None:
        if self.stopped:
            return
        t0 = time.perf_counter()
        # Spin-compute for ~grain_us: a deterministic arithmetic loop.
        acc = 0
        target = t0 + self.grain_us * 1e-6
        while time.perf_counter() < target:
            acc += 1
        self.busy_s += time.perf_counter() - t0
        self.iterations += 1
        self.sched.enqueue(self.pe, self._iter, label="bg")
