"""Persistent reader service: pooled workers, recycled arenas, admission.

The process backend (``core/buffers.py`` ``ProcessReaderSet``) builds its
reader runtime per session: one fresh interpreter a worker, plus arena
creation and prefault, on every ``start_session``. That suits one long
ingest session and not session churn (a step that re-reads a window,
serving, checkpoint restore). :class:`ReaderService` turns the ipc
subsystem into a long-lived *service* — the delegation model of Zhang et
al.'s collective I/O for loosely coupled programs: a pool of persistent
reader workers that sessions are checked out of, instead of a fleet
started per file.

Three pools and one poller:

* **Worker pool** — ``pool_workers`` long-lived workers running
  ``ipc/worker.py`` :func:`~repro_torch.ipc.worker.service_worker_main`:
  fresh interpreters (``backend="process"``; ``WorkerProcess`` with the
  boot on stdin, never ``multiprocessing``'s spawn, which would re-import
  the caller's ``__main__`` — torch and the models — in every worker) or
  threads (``backend="thread"``). A parked worker waits on its
  :class:`~repro_torch.ipc.ring.CommandRing` mailbox; arming a session
  mails it a pickled, epoch-stamped ``WorkerSpec``; it re-opens its own
  fds, runs the attach → barrier → drain protocol through its persistent
  event ring, reports DONE and ``done_epoch``, and parks again. A
  steady-state session start is one mailbox write and one attach barrier.
* **Arena pool** — :class:`ArenaPool` recycles prefaulted shm segments by
  power-of-two size class. A recycled segment keeps its first-touch
  placement, so a steady-state start faults no page and runs no
  ``ftruncate``; every checkout bumps the segment's generation so a stale
  view fails fast (``SharedArena.check_generation``).
* **Admission and fair scheduling** — at most ``max_sessions`` sessions run
  at once; more submissions queue FIFO up to ``max_queue``, past which a
  descriptive :class:`ServiceBusy` is raised. Workers are granted per
  session with a per-tenant fair share (``pool // distinct tenants``): a
  tenant holding its share is skipped while another tenant waits; within a
  tenant the order stays FIFO.
* **MPSC fan-in** — one poller thread demultiplexes every pool worker's
  SPSC event ring. Events carry the epoch they were produced under; the
  poller routes each to its session's ``_on_ring_event`` (the process
  backend's ``_mark_done`` fan-out) and drops and counts events whose epoch
  matches no live session (``ServiceMetrics.stale_events``).

A worker's report (submit kind, in-flight high-water mark, direct tails;
its start-up times on its first session only) sits in its ring's message
area, which :meth:`EventRing.rearm_reset` truncates: the service reads it
when the worker checks in, after ``done_epoch`` caught up and before the
reset, and folds it into the session it ran.

Failure containment: a pooled worker that crashes or errors is **evicted
from the pool** — only it. Its session recovers per its own ``recovery``
option (``"respawn"``: a re-arm of the unfinished tail on another pool
worker, bounded by ``max_respawns``; ``"reissue"``: a supervisor-side
re-read) or fails alone (``"none"``); sibling sessions are never torn
down. A replacement worker is checked in lazily at the next dispatch, and
its interpreter is started outside the service's lock: until it boots,
the command it may already hold waits in its mailbox, and the session's
``attach_timeout_s`` covers the boot.

``Director.attach_service`` routes ``backend="process"`` sessions through
the service (:class:`ServiceReaderSet`); with no service attached — or when
the service is saturated and ``FileOptions.use_service`` is left at auto —
the per-session spawn path runs unchanged.

Teardown: ``shutdown()`` retires every worker through its mailbox, reaps
the processes and unlinks every named segment (mailboxes, event rings,
pooled arenas), so ``/dev/shm`` holds nothing of the service afterwards.
The price of a long-lived pool is that those names stay linked for the
service's lifetime (a SIGKILL of the consumer leaks names, not pages:
orphaned workers notice through ``getppid`` and exit).
"""
from __future__ import annotations

import itertools
import os
import pickle
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.buffers import ProcessReaderSet, ReaderOptions
from repro_torch.core.metrics import ServiceMetrics, SessionMetrics
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.io.layout import Splinter, StripePlan
from repro_torch.io.submit import ring_selected
from repro_torch.ipc.ring import (
    PIN_NONE,
    PIN_OK,
    ST_DONE,
    ST_ERROR,
    ST_INIT,
    CommandRing,
    EventRing,
    RingEvent,
    ring_bytes,
)
from repro_torch.ipc.shm import PREFIX, SharedArena, shm_dir
from repro_torch.ipc.worker import (
    ServiceWorkerBoot,
    SpecSpill,
    WorkerCrashed,
    WorkerProcess,
    WorkerSpec,
    service_worker_main,
)


class ServiceBusy(RuntimeError):
    """The reader service cannot admit this session: the inflight-session
    cap and the bounded admission queue are both full (or the service is
    shut down). The message names the caps so callers can size them; the
    Director's auto mode falls back to per-session spawn instead of
    surfacing this."""


@dataclass
class ServiceOptions:
    """Construction-time knobs for :class:`ReaderService`."""

    pool_workers: int = 4            # persistent reader workers
    backend: str = "process"         # "process" | "thread" pool substrate
    ring_slots: int = 512            # event-ring capacity per worker
    cmd_bytes: int = 1 << 20         # mailbox payload capacity (spec pickle)
    max_sessions: int = 8            # inflight-session admission cap
    max_queue: int = 16              # bounded FIFO admission queue
    max_workers_per_session: int = 0  # 0 = no per-session cap beyond pool
    fair_share: bool = True          # per-tenant worker fair share
    attach_timeout_s: float = 120.0  # arm -> all-attached deadline (boot too)
    worker_stop_timeout_s: float = 10.0   # drain deadline at session end
    arena_pool_segments: int = 8     # recycled segments kept per service
    arena_quantum_bytes: int = 1 << 20    # size-class floor (pow2 rounded)

    def __post_init__(self) -> None:
        if self.backend not in ("process", "thread"):
            raise ValueError(f"unknown service backend {self.backend!r}")
        if self.pool_workers < 1:
            raise ValueError("service needs at least one pool worker")
        if self.max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0")


def _size_class(nbytes: int, quantum: int) -> int:
    """Smallest power-of-two multiple of ``quantum`` holding ``nbytes`` —
    the arena-pool bucketing that lets differently-sized sessions reuse
    the same prefaulted segments."""
    size = max(quantum, 1)
    while size < nbytes:
        size <<= 1
    return size


class ArenaPool:
    """Recycles prefaulted shm segments by size class.

    ``acquire`` prefers the smallest free segment that fits (its pages are
    already faulted and placed by the session that first used it) and
    creates a fresh one only on a miss; every checkout bumps the segment's
    ``generation`` so stale views fail fast. ``release`` returns a segment
    to the free list unless it is quarantined (borrowed views still pinned
    by a live export — recycling it would alias the next session's data)
    or the pool is full, in which case it is unlinked at once.
    """

    def __init__(self, max_segments: int, quantum: int,
                 metrics: Optional[ServiceMetrics] = None):
        self.max_segments = max_segments
        self.quantum = quantum
        self.metrics = metrics
        self._lock = threading.Lock()
        self._free: List[SharedArena] = []
        self._shutdown = False

    def acquire(self, nbytes: int) -> Tuple[SharedArena, bool]:
        """Returns ``(arena, recycled)``; ``arena.nbytes >= nbytes``."""
        size = _size_class(nbytes, self.quantum)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("arena pool is shut down")
            fits = [a for a in self._free if a.nbytes >= size]
            if fits:
                arena = min(fits, key=lambda a: a.nbytes)
                self._free.remove(arena)
                arena.generation += 1
                if self.metrics is not None:
                    self.metrics.record_arena(recycled=True)
                return arena, True
        arena = SharedArena.create(size, tag="svc")
        arena.generation = 1
        if self.metrics is not None:
            self.metrics.record_arena(recycled=False)
        return arena, False

    def release(self, arena: SharedArena, quarantine: bool = False) -> None:
        if arena.closed:
            return
        with self._lock:
            if (not quarantine and not self._shutdown
                    and len(self._free) < self.max_segments):
                self._free.append(arena)
                return
        arena.close()                 # unlink + unmap (pinned exports safe)

    def free_segments(self) -> int:
        with self._lock:
            return len(self._free)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            free, self._free = self._free, []
        for arena in free:
            arena.close()


@dataclass
class _PoolWorker:
    """One persistent pool member: its mailbox, event ring, and — while
    armed — the session wave it is running."""

    wid: int
    cmd_shm: SharedArena
    cmd: CommandRing
    ring_shm: SharedArena
    ring: EventRing
    runner: object                   # WorkerProcess | threading.Thread
    started: bool = False            # runner.start() has returned (or failed)
    epoch: int = 0                   # 0 = parked/idle
    state: Optional["_SessionState"] = None
    assignment: Tuple[Splinter, ...] = ()
    retired: bool = False

    def alive(self) -> bool:
        # A worker whose interpreter is still being started counts as
        # alive: its command waits in the mailbox, under the wave deadline.
        return not self.started or bool(self.runner.is_alive())

    def label(self) -> str:
        return f"pooled reader worker {self.wid} (pid {self.ring.pid()})"


@dataclass
class _Wave:
    """One arm wave: the workers granted to a session under one epoch.
    The primary wave runs the collective attach barrier (first-touch
    placement must complete before any read); supplementary waves
    (respawn re-arms) open their gate per worker, prefault off."""

    epoch: int
    state: "_SessionState"
    workers: List[_PoolWorker]
    t_armed: float
    deadline: float
    primary: bool
    opened: bool = False


@dataclass
class _SessionState:
    """Service-side bookkeeping for one submitted session."""

    set_: "ServiceReaderSet"
    tenant: str
    want: int
    t_submit: float
    armed: bool = False
    finished: bool = False
    failed: bool = False
    outstanding: int = 0             # armed workers not yet checked in
    workers: List[_PoolWorker] = field(default_factory=list)
    epochs: List[int] = field(default_factory=list)
    respawns_used: int = 0
    submit_kinds: set = field(default_factory=set)
    drained_evt: threading.Event = field(default_factory=threading.Event)

    def __post_init__(self) -> None:
        self.drained_evt.set()       # nothing armed yet = nothing to drain


class ReaderService:
    """The long-lived reader runtime: worker pool, arena pool, admission
    controller and one MPSC demux poller (the module docstring has the
    model).

    Thread-safety: every pool/queue/wave mutation happens under
    ``self._lock``; event-ring consumption is poller-only (each ring stays
    SPSC); per-session fan-out goes through the session's own locks. No
    worker interpreter is started under ``self._lock``: members are created
    under it and started by :meth:`_start_pending` after it is released.
    """

    def __init__(self, opts: Optional[ServiceOptions] = None):
        self.opts = opts or ServiceOptions()
        self.metrics = ServiceMetrics()
        self.arenas = ArenaPool(self.opts.arena_pool_segments,
                                self.opts.arena_quantum_bytes,
                                metrics=self.metrics)
        self._lock = threading.Lock()
        self._workers: List[_PoolWorker] = []
        self._idle: List[_PoolWorker] = []
        self._unstarted: List[_PoolWorker] = []
        self._waitq: List[_SessionState] = []
        self._running: List[_SessionState] = []
        self._waves: Dict[int, _Wave] = {}
        self._epoch_states: Dict[int, _SessionState] = {}
        self._epochs = itertools.count(1)
        self._wid = itertools.count()
        self._shutdown = False
        self._capacity_listeners: List = []
        self.director = None         # set by Director.attach_service
        try:
            with self._lock:
                for _ in range(self.opts.pool_workers):
                    self._spawn_worker_locked()
            self._start_pending()
        except BaseException:
            self._close_segments(self._workers)
            raise
        self._poller = threading.Thread(
            target=self._poll_main, daemon=True, name="ckio-service-poller")
        self._poller.start()

    # -- pool membership ------------------------------------------------------
    def _spawn_worker_locked(self) -> _PoolWorker:
        """Create one pool member (its own mailbox and ring segments) and
        queue its start: :meth:`_start_pending` starts it once the lock is
        released. It joins the idle list at once, so a session may be armed
        on it while it boots. Caller holds ``self._lock``."""
        wid = next(self._wid)
        rb = ring_bytes(self.opts.ring_slots)
        cmd_shm = SharedArena.create(self.opts.cmd_bytes, tag="svc-cmd")
        try:
            ring_shm = SharedArena.create(rb, tag="svc-ring")
        except BaseException:
            cmd_shm.close()
            raise
        cmd = CommandRing(cmd_shm.buf, create=True)
        ring = EventRing(ring_shm.buf[:rb], self.opts.ring_slots, create=True)
        boot = ServiceWorkerBoot(
            worker_id=wid,
            cmd_path=cmd_shm.path,
            cmd_bytes=self.opts.cmd_bytes,
            ring_path=ring_shm.path,
            ring_region_bytes=rb,
            ring_offset=0,
            ring_slots=self.opts.ring_slots,
            # Thread workers share our pid — getppid() would "mismatch"
            # forever, so the orphan guard only arms for real processes.
            parent_pid=os.getpid() if self.opts.backend == "process" else 0,
        )
        if self.opts.backend == "process":
            runner = WorkerProcess(boot, name=f"ckio-svc-{wid}",
                                   entry="_service_child_main")
        else:
            runner = threading.Thread(target=service_worker_main,
                                      args=(boot,), daemon=True,
                                      name=f"ckio-svc-{wid}")
        worker = _PoolWorker(wid=wid, cmd_shm=cmd_shm, cmd=cmd,
                             ring_shm=ring_shm, ring=ring, runner=runner)
        self._workers.append(worker)
        self._idle.append(worker)
        self._unstarted.append(worker)
        self.metrics.record_worker_spawned()
        return worker

    def _start_pending(self) -> None:
        """Start the members created under the lock (``Popen`` of a fresh
        interpreter, or a thread) — never under ``self._lock``. A start that
        fails leaves the member dead; the poller then evicts it, and the
        session armed on it recovers or fails per its own options."""
        with self._lock:
            todo, self._unstarted = self._unstarted, []
        for w in todo:
            if w.retired:            # evicted before it ever ran
                w.started = True
                continue
            try:
                w.runner.start()
                if isinstance(w.runner, WorkerProcess):
                    w.runner.send()
            except OSError:
                pass                 # not alive: handled as a dead worker
            finally:
                w.started = True

    def _evict_locked(self, worker: _PoolWorker) -> None:
        """Remove ``worker`` from the pool — only it; sibling sessions and
        workers are untouched. A replacement is NOT created here: dispatch
        checks the pool back in lazily (the next session to need a worker
        pays the start, nobody else stalls)."""
        if worker.retired:
            return
        worker.retired = True
        if worker in self._idle:
            self._idle.remove(worker)
        worker.cmd.request_stop()
        if self.opts.backend == "process" and worker.started:
            worker.runner.kill()
        worker.epoch = 0
        worker.state = None
        worker.assignment = ()
        self.metrics.record_worker_evicted()

    def pool_size(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if not w.retired)

    def idle_workers(self) -> int:
        with self._lock:
            return len(self._idle)

    # -- admission hooks (serving-side flow control) --------------------------
    def admission_snapshot(self) -> Dict[str, int]:
        """Point-in-time admission state: inflight/queued sessions against
        their caps. Advisory — the numbers can change the moment the lock
        drops; callers use it to *pace*, never to guarantee admission."""
        with self._lock:
            return {
                "inflight": len(self._running),
                "queued": len(self._waitq),
                "max_sessions": self.opts.max_sessions,
                "max_queue": self.opts.max_queue,
                "idle_workers": len(self._idle),
            }

    def would_admit(self) -> bool:
        """Advisory pre-check: would :meth:`submit` (probably) not raise
        :class:`ServiceBusy` right now? Racy by design — a ``True`` here can
        still lose to a concurrent submit, so callers must keep handling
        ``ServiceBusy``; the point is to let pacing loops (the serve
        ingester) avoid exception-driven churn in the common case."""
        with self._lock:
            if self._shutdown:
                return False
            return (len(self._running) < self.opts.max_sessions
                    or len(self._waitq) < self.opts.max_queue)

    def add_capacity_listener(self, cb) -> None:
        """Register ``cb()`` to fire (outside the service lock, poller or
        caller thread) whenever admission capacity may have freed — a
        session ended or left the wait queue. Listeners must be cheap and
        exception-safe; they get no arguments, only the hint to re-poll
        :meth:`admission_snapshot` or retry a queued submit."""
        with self._lock:
            self._capacity_listeners.append(cb)

    def _notify_capacity(self) -> None:
        with self._lock:
            listeners = list(self._capacity_listeners)
        for cb in listeners:
            try:
                cb()
            except Exception:
                pass                 # listener bugs never poison the service

    # -- admission ------------------------------------------------------------
    def submit(self, set_: "ServiceReaderSet") -> None:
        """Admit ``set_`` and (FIFO and fair share permitting) arm it on
        checked-out pool workers. Raises :class:`ServiceBusy` when both the
        inflight cap and the admission queue are full."""
        state = _SessionState(
            set_=set_,
            tenant=set_.tenant,
            want=self._want(set_),
            t_submit=time.monotonic(),
        )
        try:
            with self._lock:
                if self._shutdown:
                    raise ServiceBusy("reader service is shut down")
                set_._svc_state = state
                self._waitq.append(state)
                self._dispatch_locked()
                if not state.armed:
                    if len(self._waitq) > self.opts.max_queue:
                        self._waitq.remove(state)
                        set_._svc_state = None
                        self.metrics.record_rejected()
                        raise ServiceBusy(
                            f"reader service saturated: "
                            f"{len(self._running)} session(s) inflight (cap "
                            f"{self.opts.max_sessions}), admission queue "
                            f"full at {self.opts.max_queue}; retry, raise "
                            f"ServiceOptions.max_queue/max_sessions, or fall"
                            f" back to per-session spawn")
                    self.metrics.record_queued(len(self._waitq))
                self.metrics.record_admitted()
        finally:
            self._start_pending()

    def _want(self, set_: "ServiceReaderSet") -> int:
        want = min(set_.plan.num_readers, max(1, set_.opts.max_workers))
        if self.opts.max_workers_per_session > 0:
            want = min(want, self.opts.max_workers_per_session)
        return max(1, want)

    def _dispatch_locked(self) -> None:
        """FIFO + fair-share scan of the wait queue; arms what it can.

        Fair share: with T distinct tenants running or waiting, each is
        entitled to ``pool // T`` workers (floor 1). A tenant at or over its
        share is skipped while a different tenant waits behind it; within
        one tenant, order stays FIFO. The pool is checked back up to its
        target size here (lazy replacement of evicted workers; their
        interpreters start after the lock is released)."""
        if self._shutdown:
            return
        while self._waitq and len(self._running) < self.opts.max_sessions:
            live = sum(1 for w in self._workers if not w.retired)
            for _ in range(self.opts.pool_workers - live):
                try:
                    self._spawn_worker_locked()
                except OSError:
                    break            # resource pressure: run with fewer
            if not self._idle:
                return
            tenants = {s.tenant for s in self._running}
            tenants.update(s.tenant for s in self._waitq)
            share = max(1, self.opts.pool_workers // max(1, len(tenants)))
            in_use: Dict[str, int] = {}
            for s in self._running:
                in_use[s.tenant] = in_use.get(s.tenant, 0) + len(s.workers)
            picked = None
            for s in self._waitq:
                if not self.opts.fair_share:
                    picked = s
                    break
                others_wait = any(o.tenant != s.tenant for o in self._waitq)
                if others_wait and in_use.get(s.tenant, 0) >= share:
                    continue         # over share while someone else waits
                picked = s
                break
            if picked is None:
                return
            grant = len(self._idle)
            if self.opts.fair_share and any(
                    o.tenant != picked.tenant for o in self._waitq
                    if o is not picked):
                grant = min(grant,
                            max(1, share - in_use.get(picked.tenant, 0)))
            grant = min(grant, picked.want)
            if grant < 1:
                return
            self._waitq.remove(picked)
            self._running.append(picked)
            self._arm_locked(picked, grant)

    # -- arming ---------------------------------------------------------------
    def _arm_locked(self, state: _SessionState, grant: int,
                    splinters: Optional[List[Splinter]] = None,
                    primary: bool = True) -> None:
        """Check ``grant`` workers out of the pool and mail each its spec.
        ``splinters=None`` arms the session's full plan split round-robin
        by reader (the primary wave: collective attach barrier, optional
        prefault); an explicit list is a supplementary re-arm of a crashed
        worker's unfinished tail."""
        set_ = state.set_
        epoch = next(self._epochs)
        workers = [self._idle.pop() for _ in range(grant)]
        plan = set_.plan
        now = time.monotonic()
        wave = _Wave(epoch=epoch, state=state, workers=workers, t_armed=now,
                     deadline=now + self.opts.attach_timeout_s,
                     primary=primary)
        state.armed = True
        state.drained_evt.clear()
        state.epochs.append(epoch)
        state.workers.extend(workers)
        state.outstanding += len(workers)
        self._waves[epoch] = wave
        self._epoch_states[epoch] = state
        self.metrics.record_rearm(len(workers))
        rb = ring_bytes(self.opts.ring_slots)
        for k, worker in enumerate(workers):
            if splinters is None:
                owned = list(range(k, plan.num_readers, grant))
                sps = tuple(sp for r in owned
                            for sp in plan.splinters_for_reader(r))
                bounds = tuple(plan.stripe_bounds[r] for r in owned)
                # A recycled segment keeps its first-touch placement:
                # re-touching it is the work the arena pool exists to skip.
                prefault = set_.opts.prefault_arena and not set_.arena_recycled
                pin_cpus = None
                topo = set_.opts.topology
                if set_.opts.numa_pin and topo is not None and owned:
                    cpus = topo.cpus_of_domain(set_.reader_domain(owned[0]))
                    pin_cpus = tuple(cpus) if cpus else None
            else:
                sps = tuple(splinters)
                bounds = ()
                prefault = False
                pin_cpus = None
            spec = WorkerSpec(
                worker_id=worker.wid,
                file_path=set_.file.path,
                arena_path=set_._shm.path,
                arena_bytes=plan.nbytes,
                base_offset=set_._base,
                ring_path=worker.ring_shm.path,
                ring_region_bytes=rb,
                ring_offset=0,
                ring_slots=self.opts.ring_slots,
                splinters=sps,
                stripe_bounds=bounds,
                prefault=prefault,
                pin_cpus=pin_cpus,
                delay_model=set_.opts.delay_model,
                fault=set_.opts.worker_fault,
                io_fault=set_.opts.io_fault,
                ring_fault=set_.opts.ring_fault,
                parent_pid=(os.getpid()
                            if self.opts.backend == "process" else 0),
                shards=getattr(set_.file, "worker_segments", None),
                direct_io=set_.opts.direct_io,
                queue_depth=set_.opts.queue_depth,
                readahead_bytes=set_.opts.readahead_bytes,
                submit_mode=set_.opts.submit_mode,
                epoch=epoch,
            )
            worker.epoch = epoch
            worker.state = state
            worker.assignment = sps
            worker.ring.rearm_reset()
            payload = pickle.dumps(spec)
            if len(payload) > worker.cmd.capacity:
                # Oversized spec (very fine splinters): spill the pickle to
                # a tmpfs file and mail the small marker instead.
                path = os.path.join(
                    shm_dir(), f"{PREFIX}spill-{os.getpid()}-"
                    f"{secrets.token_hex(6)}")
                with open(path, "wb") as fh:
                    fh.write(payload)
                payload = pickle.dumps(SpecSpill(path, len(payload)))
            worker.cmd.send(epoch, payload)
        self.metrics.record_occupancy(
            sum(1 for w in self._workers if not w.retired and w.epoch))

    # -- MPSC demux poller ----------------------------------------------------
    def _route(self, ev: RingEvent) -> None:
        state = self._epoch_states.get(ev.epoch)
        if state is None or state.failed or state.finished:
            # Late event from a torn-down / failed session's generation (or
            # a corrupted epoch): dropped, counted, never delivered.
            self.metrics.record_stale_event()
            return
        state.set_._on_ring_event(ev)

    def _poll_main(self) -> None:
        pause = 50e-6
        while True:
            with self._lock:
                if self._shutdown:
                    return
                workers = [w for w in self._workers if not w.retired]
            progressed = 0
            # 1. Drain every live ring (idle rings are normally empty; a
            #    stale event parked in one is counted and dropped).
            for w in workers:
                events = w.ring.consume(limit=1024)
                for ev in events:
                    self._route(ev)
                progressed += len(events)
            # 2. Attach barriers / deadlines per wave.
            with self._lock:
                waves = list(self._waves.values())
            for wave in waves:
                if not wave.opened:
                    progressed += self._check_wave(wave)
            # 3. Worker completion / death.
            for w in workers:
                if w.epoch and not w.retired:
                    progressed += self._check_worker(w)
            # 4. Freed capacity -> next queued session.
            with self._lock:
                if self._waitq and self._idle:
                    self._dispatch_locked()
            self._start_pending()
            if progressed:
                pause = 50e-6
            else:
                time.sleep(pause)
                pause = min(pause * 2, 2e-3)

    def _check_wave(self, wave: _Wave) -> int:
        """Run one wave's attach barrier step. A worker erroring (or dying)
        before the barrier completes is terminal for the SESSION (the
        collective first-touch placement cannot be re-run) and an eviction
        for the WORKER — never a pool teardown."""
        states = [w.ring.state() for w in wave.workers]
        dead = [w for w, st in zip(wave.workers, states)
                if st == ST_ERROR or (st != ST_DONE and not w.alive())]
        if dead:
            msgs = []
            for w in dead:
                for ev in w.ring.consume():
                    self._route(ev)
                msgs.append(f"{w.label()}: "
                            f"{w.ring.error_message() or 'died'}")
            self._fail_session(
                wave.state,
                WorkerCrashed(
                    "pooled worker failed during session attach ("
                    + "; ".join(msgs) + ")"),
                evict=dead)
            return 1
        if all(st != ST_INIT for st in states):
            set_ = wave.state.set_
            for w in wave.workers:
                pages, pin = w.ring.touch_report()
                if pages:
                    set_.locality.record_prefault(pages)
                if pin != PIN_NONE:
                    set_.locality.record_pin(pin == PIN_OK)
                w.ring.open_gate()
            wave.opened = True
            if set_._cancelled:
                # Cancelled before the barrier completed: the workers park
                # through their stop flag; _gates_open stays False so
                # wait_attached reports the cancellation.
                return 1
            if wave.primary:
                latency = time.monotonic() - wave.state.t_submit
                self.metrics.record_checkout(latency)
                set_.metrics.record_service_checkout(
                    wave.epoch, latency, set_.arena_recycled)
                set_.metrics.record_workers_attached(
                    [w.ring.pid() for w in wave.workers], latency)
                set_._gates_open = True
                set_._attached_evt.set()
            return 1
        if time.monotonic() > wave.deadline:
            stuck = [w for w, st in zip(wave.workers, states)
                     if st == ST_INIT]
            self._fail_session(
                wave.state,
                WorkerCrashed(
                    f"pooled worker(s) {[w.wid for w in stuck]} failed to "
                    f"attach within {self.opts.attach_timeout_s}s"),
                evict=stuck)
            return 1
        return 0

    def _check_worker(self, worker: _PoolWorker) -> int:
        """Detect one armed worker's completion (check it back in) or
        death/error (evict and recover per session)."""
        st = worker.ring.state()
        state = worker.state
        wave = self._waves.get(worker.epoch)
        if st == ST_DONE and worker.ring.done_epoch() == worker.epoch:
            # done_epoch is written after the last publish, so this final
            # drain is complete — the ring can be reset after the report.
            for ev in worker.ring.consume():
                self._route(ev)
            self._checkin(worker)
            return 1
        if st == ST_ERROR or not worker.alive():
            for ev in worker.ring.consume():
                self._route(ev)
            if state is not None:
                r, s = worker.ring.io_report()
                if r or s:
                    state.set_.metrics.recovery.add_worker_io(r, s)
            if state is None:
                with self._lock:
                    self._evict_locked(worker)
                return 1
            if st == ST_ERROR:
                msg = f"{worker.label()} failed: {worker.ring.error_message()}"
            else:
                msg = (f"{worker.label()} died before completing its "
                       f"splinters")
            gated = wave is not None and not wave.opened
            self._recover(worker, state, msg, gated)
            return 1
        return 0

    def _fold_report(self, worker: _PoolWorker, state: _SessionState) -> None:
        """Fold a DONE worker's ring counters and report (submit kind,
        in-flight high-water mark, direct tails; start-up times on its
        first session) into the session it ran. Runs before the ring's
        ``rearm_reset``, which truncates the report."""
        m = state.set_.metrics
        r, s = worker.ring.io_report()
        rep = worker.ring.report()
        tails = int(rep.get("tails", 0))
        if r or s or tails:
            m.recovery.add_worker_io(r, s, tails, int(rep.get("tail_bytes", 0)))
        if "submit" in rep:
            state.submit_kinds.add(rep["submit"])
            m.record_inflight_hwm(int(rep["hwm"]))
            with m.lock:
                m.submit_backend = "+".join(sorted(state.submit_kinds))
        if "t_boot" in rep:
            t_boot, t_ready = float(rep["t_boot"]), float(rep["t_ready"])
            m.record_worker_boot(t_boot - worker.runner.t_start,
                                 t_ready - t_boot)

    def _checkin(self, worker: _PoolWorker) -> None:
        """Return a drained worker to the idle pool: fold its report into
        the session it ran, reset its ring, park it."""
        state = worker.state
        if state is not None:
            self._fold_report(worker, state)
        with self._lock:
            worker.ring.rearm_reset()
            worker.epoch = 0
            worker.state = None
            worker.assignment = ()
            if not worker.retired:
                self._idle.append(worker)
            if state is not None:
                state.outstanding -= 1
                if state.outstanding <= 0:
                    state.drained_evt.set()
            self._dispatch_locked()
        self._start_pending()
        self._notify_capacity()

    def _recover(self, worker: _PoolWorker, state: _SessionState,
                 msg: str, gated: bool) -> None:
        """A pooled worker crashed/errored mid-session: evict it (only it)
        and recover or fail only THIS session; siblings are untouched."""
        set_ = state.set_
        unfinished = [sp for sp in worker.assignment
                      if not set_._done_snapshot(sp.index)]
        with self._lock:
            self._evict_locked(worker)
            state.outstanding -= 1
            if state.outstanding <= 0:
                state.drained_evt.set()
        if gated:
            self._fail_session(state, WorkerCrashed(
                f"{msg} (during attach barrier — terminal)"))
            return
        if not unfinished:
            return                   # died after its last publish: harmless
        mode = set_.opts.recovery
        t_detect = time.monotonic()
        if mode == "respawn":
            if state.respawns_used >= set_.opts.max_respawns:
                self._fail_session(state, WorkerCrashed(
                    f"{msg}; respawn budget exhausted "
                    f"({set_.opts.max_respawns})"))
                return
            state.respawns_used += 1
            armed = False
            with self._lock:
                live = sum(1 for w in self._workers if not w.retired)
                if live < self.opts.pool_workers:
                    try:
                        self._spawn_worker_locked()
                    except OSError:
                        pass
                if self._idle:
                    set_.metrics.recovery.record_respawn(
                        len(unfinished),
                        sum(sp.nbytes for sp in unfinished),
                        by_shard=set_._shard_attribution(unfinished))
                    self._arm_locked(state, 1, splinters=unfinished,
                                     primary=False)
                    set_.metrics.recovery.record_recovery_latency(
                        time.monotonic() - t_detect)
                    armed = True
            self._start_pending()
            if not armed:
                # Pool exhausted: degrade to supervisor-side re-issue
                # rather than stall the session behind the admission queue.
                set_._reissue_splinters(unfinished, t_detect)
            return
        if mode == "reissue":
            set_._reissue_splinters(unfinished, t_detect)
            return
        self._fail_session(state, WorkerCrashed(msg))

    def _fail_session(self, state: _SessionState, exc: BaseException,
                      evict: Optional[List[_PoolWorker]] = None) -> None:
        """Fail ONE session: route the error through its own ``_fail``
        (waiters, join, wait_attached all unblock with it), stop its
        remaining workers gracefully, and mark its epochs stale so any late
        event is dropped and counted. Sibling sessions keep running."""
        with self._lock:
            if state.failed or state.finished:
                return
            state.failed = True
            for w in evict or ():
                if w.state is state:
                    state.outstanding -= 1
                self._evict_locked(w)
            if state.outstanding <= 0:
                state.drained_evt.set()
            for w in state.workers:
                if not w.retired and w.epoch and w.state is state:
                    w.ring.request_stop()
        self.metrics.record_session_failed()
        state.set_._fail(exc)

    # -- session end ----------------------------------------------------------
    def end_session(self, set_: "ServiceReaderSet",
                    quarantine: bool = False) -> None:
        """Tear one session out of the service: dequeue it, or stop its
        workers and wait for them to park, then hand its arena back to the
        pool — quarantined (unlinked instead of recycled) when borrowed
        views are still pinned by live exports or ``quarantine`` is set, so
        recycling can never alias."""
        state: Optional[_SessionState] = getattr(set_, "_svc_state", None)
        arena = set_._shm
        try:
            if state is None:
                return
            with self._lock:
                if state.finished:
                    return
                if state in self._waitq:     # never armed: just dequeue
                    self._waitq.remove(state)
                    state.finished = True
                    return
                for w in state.workers:
                    if not w.retired and w.epoch and w.state is state:
                        w.ring.request_stop()
            if not state.drained_evt.wait(
                    self.opts.worker_stop_timeout_s + 5.0):
                # Hung worker (stuck pread): evict rather than wait — the
                # pool replaces it lazily; a thread-substrate worker cannot
                # be killed and is abandoned (daemon thread), so its arena
                # is quarantined below.
                quarantine = True
                with self._lock:
                    for w in state.workers:
                        if w.state is state and not w.retired:
                            self._evict_locked(w)
                    state.outstanding = 0
                    state.drained_evt.set()
            with self._lock:
                state.finished = True
                if state in self._running:
                    self._running.remove(state)
                for e in state.epochs:
                    self._waves.pop(e, None)
                    self._epoch_states.pop(e, None)
                self._dispatch_locked()
            self._start_pending()
        finally:
            # Hand the arena back exactly once: a later end_session sees
            # _shm already cleared.
            set_._shm = None
            if arena is not None and not arena.closed:
                self.arenas.release(
                    arena, quarantine=quarantine or set_._pinned_borrows > 0)
            self._notify_capacity()

    # -- teardown -------------------------------------------------------------
    def _close_segments(self, workers: List[_PoolWorker]) -> None:
        for w in workers:
            w.cmd_shm.close()
            w.ring_shm.close()

    def shutdown(self, timeout: float = 15.0) -> None:
        """Retire the pool and unlink every named segment. Idempotent.
        After this returns, nothing of the service remains in /dev/shm."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self._workers)
            for state in self._waitq + self._running:
                if not state.finished:
                    state.failed = True
                    state.drained_evt.set()
            self._waitq = []
            self._idle = []
            never, self._unstarted = self._unstarted, []
            for w in never:          # retired before it ever ran
                w.retired = w.started = True
        for w in workers:
            w.cmd.request_stop()
            w.ring.request_stop()
        if self._poller.is_alive():
            self._poller.join(timeout)
        deadline = time.monotonic() + timeout
        for w in workers:
            if not w.started:
                continue
            if self.opts.backend == "process":
                if w.runner.pid is not None:
                    w.runner.join(max(0.0, deadline - time.monotonic()))
                    if w.runner.is_alive():
                        w.runner.kill()
                        w.runner.join(5.0)
            elif w.runner.is_alive():
                w.runner.join(max(0.1, deadline - time.monotonic()))
        self._close_segments(workers)
        self.arenas.shutdown()


class ServiceReaderSet(ProcessReaderSet):
    """A session running on the pooled reader service.

    Inherits the supervisor-facing surface of the process backend —
    ``_mark_done`` fan-out, waiters, the splinter stream, zero-copy
    ``view``/``borrow_view`` (``bytes_copied == 0`` holds: the pooled arena
    is the same kind of mapped segment), ``join``/``_fail`` and the
    supervisor-side ``_reissue_splinters`` recovery — but owns **no
    processes and no poller**: ``start`` submits to the service (which may
    raise :class:`ServiceBusy`), the service's demux poller feeds
    ``_on_ring_event``, and ``release`` returns the recycled arena to the
    pool instead of unlinking it.
    """

    def __init__(self, file, plan: StripePlan, sched: TaskScheduler,
                 reader_pes: List[int], opts: ReaderOptions,
                 service: ReaderService, tenant: str = "",
                 metrics: Optional[SessionMetrics] = None):
        self.service = service
        self.tenant = tenant or "default"
        self.arena_recycled = False
        self.arena_generation = 0
        self._svc_state: Optional[_SessionState] = None
        super().__init__(file, plan, sched, reader_pes, opts, metrics)

    def _alloc_arena(self, plan: StripePlan) -> np.ndarray:
        arena, recycled = self.service.arenas.acquire(plan.nbytes)
        self._shm = arena
        self.arena_recycled = recycled
        self.arena_generation = arena.generation
        # The pool segment is a size class (>= nbytes): the session sees
        # exactly its window from offset 0, so the base stays page-aligned
        # (O_DIRECT) and the slack stays invisible.
        return arena.ndarray()[: plan.nbytes]

    def _done_snapshot(self, index: int) -> bool:
        with self._lock:
            return self._done[index]

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self.started:
            return
        self._validate_direct_io()
        self.started = True
        self.metrics.direct_io = bool(getattr(self.file, "direct_io", False))
        self.metrics.session_started(self.plan.nbytes, self.plan.num_readers)
        if self.opts.queue_depth >= 2:
            # The workers report the backend they took; the same selection
            # rule runs here first, so a forced io_uring that cannot run
            # fails the session start, not a worker.
            kind = "io_uring" if ring_selected(
                self.file, self.opts.submit_mode,
                self.opts.delay_model) else "threads"
            self.metrics.record_submit_config(
                self.opts.queue_depth, self.opts.readahead_bytes, kind,
                bool(getattr(self.file, "direct_io", False)))
        if not self.plan.splinters:
            self._gates_open = True
            self._attached_evt.set()
            self.metrics.record_service_checkout(0, 0.0, self.arena_recycled)
            return
        self.file.advise_sequential(self.plan.offset, self.plan.nbytes,
                                    stats=self.metrics.recovery)
        # Admission happens HERE, synchronously: a ServiceBusy from a full
        # queue propagates out of the Director's session construction (auto
        # mode then falls back to per-session spawn; use_service=True
        # surfaces it).
        self.service.submit(self)

    def worker_pids(self) -> List[int]:
        state = self._svc_state
        if state is None:
            return []
        return [w.ring.pid() for w in state.workers
                if not w.retired and w.epoch and w.ring.pid()]

    def cancel(self) -> None:
        self._cancelled = True
        state = self._svc_state
        if state is not None:
            for w in list(state.workers):
                if not w.retired and w.epoch and w.state is state:
                    w.ring.request_stop()
        self._attached_evt.set()

    def stop(self, timeout: float = 30.0) -> bool:
        self.cancel()
        state = self._svc_state
        if state is None:
            return True
        return state.drained_evt.wait(timeout)

    def release(self) -> None:
        """Detach from the service: stop our workers and let them park,
        then hand the arena back to the pool. A supervisor-side re-issue
        reader still writing into the arena is joined first; one that
        outlives the join quarantines the segment. The segment is NOT
        unlinked on the happy path — that is the arena pool's point."""
        self.cancel()
        for th in self._reissue_threads:
            if th.is_alive():
                th.join(5.0)
        busy = any(th.is_alive() for th in self._reissue_threads)
        self.service.end_session(self, quarantine=busy)
