"""Director + Manager groups (paper §III-C.1/2).

The Director is the singleton coordinator: it owns the file/session tables,
allocates ids ("tags"), runs the session-start broadcast, and performs any
global sequencing between sessions of distinct files (paper: reduce FS
contention by serializing sessions when asked). Managers are the per-PE
group members: each holds its PE's ReadAssembler and acks session broadcasts;
the last ack triggers the user's ``ready`` callback — mirroring the paper's
"once all the buffer chares have finished initiating their read".
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import warnings
from typing import Callable, Dict, List, Optional

from repro_torch.core.assembler import ReadAssembler
from repro_torch.core.autotune import (
    AutoTuner,
    QueueTuner,
    SplinterSizer,
    suggest_num_readers,
)
from repro_torch.core.buffers import BufferReaderSet, ProcessReaderSet
from repro_torch.core.futures import CkCallback
from repro_torch.core.metrics import (
    LocalityMetrics,
    RecoveryMetrics,
    SessionMetrics,
    ShardMetrics,
)
from repro_torch.core.placement import place_readers
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.core.session import FileHandle, FileOptions, Session
from repro_torch.io.layout import plan_session
from repro_torch.io.posix import DEFAULT_ALIGN, PosixFile


class Manager:
    """Per-PE service chare (group member)."""

    def __init__(self, sched: TaskScheduler, pe: int):
        self.pe = pe
        self.assembler = ReadAssembler(sched, pe)
        self.sessions: Dict[int, Session] = {}

    def register_session(self, session: Session) -> None:
        self.sessions[session.id] = session

    def forget_session(self, session_id: int) -> None:
        self.sessions.pop(session_id, None)


class Director:
    """Global coordinator chare."""

    def __init__(self, sched: TaskScheduler):
        self.sched = sched
        self.managers: List[Manager] = [
            Manager(sched, pe) for pe in range(sched.num_pes)
        ]
        self._file_ids = itertools.count()
        self._session_ids = itertools.count()
        self._lock = threading.Lock()
        self.files: Dict[int, FileHandle] = {}
        self.sessions: Dict[int, Session] = {}
        # optional global sequencing: serialize session *starts* per group key
        self._sequence_lock = threading.Lock()
        # One observation path for every knob controller: close_session feeds
        # each finished session's metrics to all of these (autotune §VI-A,
        # the splinter-size controller, the cold-path queue controller, the
        # per-shard byte aggregate). Extend with ``add_observer``.
        self.tuner = AutoTuner(num_pes=sched.num_pes, num_nodes=sched.num_nodes)
        self.splinter_sizer = SplinterSizer()
        # Consulted at session start when FileOptions.adaptive_queue is set.
        self.queue_tuner = QueueTuner()
        # Director-lifetime FileSet aggregate: per-shard physical read bytes.
        self.shards = ShardMetrics()
        self._observers: List[Callable[[SessionMetrics], None]] = [
            self.tuner.record_session,
            self.splinter_sizer.record_session,
            self.queue_tuner.record_session,
            self.shards.merge_session,
        ]
        # Director-lifetime locality aggregate: each closing session's
        # per-session LocalityMetrics are merged here (cross-domain bytes,
        # per-reader splinter histograms) so drivers read one object after
        # many sessions.
        self.locality = LocalityMetrics()
        # Director-lifetime fault-recovery aggregate (respawns, re-issued
        # splinters, I/O retries, degraded sessions) — same merge-on-close
        # pattern as ``locality``.
        self.recovery = RecoveryMetrics()
        # Optional persistent reader service (ipc/service.py): when
        # attached, process-backend sessions run on its pooled workers and
        # recycled arenas instead of starting workers per session.
        self.service = None

    def attach_service(self, service) -> None:
        """Attach a :class:`~repro_torch.ipc.service.ReaderService`:
        subsequent ``backend="process"`` sessions check workers out of its
        pool (subject to ``FileOptions.use_service`` routing) and its
        :class:`~repro_torch.core.metrics.ServiceMetrics` joins the
        observer path. The caller keeps ownership: the Director never runs
        ``service.shutdown()``."""
        if self.service is service:
            return
        self.service = service
        service.director = self
        self.add_observer(service.metrics.record_session)

    def add_observer(self, observe: Callable[[SessionMetrics], None]) -> None:
        """Register a session-close observer on the shared observation path
        (it receives every finished session's ``SessionMetrics``, exactly
        like the tuners)."""
        self._observers.append(observe)

    # -- files ---------------------------------------------------------------
    def open_file(
        self, path: str, opts: FileOptions, opened: CkCallback
    ) -> None:
        def do_open() -> None:
            posix = PosixFile.open(path, direct_io=opts.direct_io)
            with self._lock:
                fid = next(self._file_ids)
                handle = FileHandle(id=fid, path=path, posix=posix, opts=opts)
                self.files[fid] = handle
            opened.send(self.sched, handle)

        # Opening is itself split-phase: runs as a task on PE 0.
        self.sched.enqueue(0, do_open, label="ckio-open")

    def open_fileset(
        self, fileset, opts: FileOptions, opened: CkCallback
    ) -> None:
        """Open a multi-shard manifest (``data/fileset.py FileSet``) as one
        logical file: the handle's ``posix`` is a ``ShardedFile`` over the
        manifest's global data byte space, so sessions/reads/streams work
        unchanged. The manifest is duck-typed (``sharded_file()``) — the
        core layer never imports the data layer."""

        def do_open() -> None:
            sharded = fileset.sharded_file(direct_io=opts.direct_io)
            with self._lock:
                fid = next(self._file_ids)
                handle = FileHandle(id=fid, path=sharded.path, posix=sharded,
                                    opts=opts, fileset=fileset)
                self.files[fid] = handle
            opened.send(self.sched, handle)

        self.sched.enqueue(0, do_open, label="ckio-open-fileset")

    def close_file(self, handle: FileHandle, closed: CkCallback) -> None:
        def do_close() -> None:
            handle.posix.close()
            with self._lock:
                self.files.pop(handle.id, None)
            closed.send(self.sched)

        self.sched.enqueue(0, do_close, label="ckio-close")

    # -- sessions --------------------------------------------------------------
    def start_session(
        self,
        file: FileHandle,
        nbytes: int,
        offset: int,
        ready: CkCallback,
        consumer_pes: Optional[List[int]] = None,
        sequenced: bool = False,
    ) -> None:
        opts = file.opts
        # Unsupported options raise here, at the call, not inside a task.
        ropts = opts.reader_options()
        num_readers = opts.num_readers or suggest_num_readers(
            nbytes, self.sched.num_pes, self.sched.num_nodes
        )
        # FileSet sessions: shard starts inside the window are HARD stripe
        # bounds (no stripe — so no splinter, so no single pread — may span
        # one). Segmenting needs >= one reader per shard segment; bump the
        # count BEFORE adaptive sizing so per-reader splinter sizes line up.
        bounds_in = getattr(file.posix, "bounds_in", None)
        hard_bounds = tuple(bounds_in(offset, nbytes)) if bounds_in else ()
        num_readers = max(num_readers, len(hard_bounds) + 1)

        def do_start() -> None:
            if sequenced:
                # Global coordination (paper §III-C.1): serialize the greedy
                # read kick-off of concurrent sessions on distinct files.
                self._sequence_lock.acquire()
            try:
                splinter_bytes = opts.splinter_bytes
                reader_sizes = None
                if opts.adaptive_splinters:
                    # Observed per-reader throughput (large on streaming
                    # stripes) shrunk by steal pressure (small near stolen
                    # tails); opts.splinter_bytes seeds the first session,
                    # and per-reader sizes (once per-stripe signal exists)
                    # let a straggling stripe alone run fine splinters.
                    splinter_bytes = self.splinter_sizer.suggest(
                        splinter_bytes)
                    reader_sizes = self.splinter_sizer.suggest_per_reader(
                        max(1, num_readers), splinter_bytes)
                plan = plan_session(
                    offset, nbytes, num_readers,
                    splinter_bytes=splinter_bytes,
                    reader_splinter_bytes=reader_sizes,
                    hard_bounds=hard_bounds or None,
                    # The file's REAL block size (statvfs probe at open):
                    # with direct_io this keeps every splinter offset
                    # O_DIRECT-legal.
                    align=getattr(file.posix, "block_size", DEFAULT_ALIGN),
                )
                reader_pes = place_readers(
                    opts.placement, plan.num_readers, self.sched,
                    consumer_pes, topology=opts.topology,
                )
                if opts.adaptive_queue:
                    # The QueueTuner's explore-then-exploit walk picks
                    # (queue_depth, readahead) from observed session
                    # throughput; the explicit fields only seed the first
                    # session (an unset/blocking depth seeds at 8 so the
                    # walk starts in async territory).
                    seed_depth = (opts.queue_depth
                                  if opts.queue_depth >= 2 else 8)
                    ropts.queue_depth, ropts.readahead_bytes = (
                        self.queue_tuner.suggest(seed_depth,
                                                 opts.readahead_bytes))
                session = self._start_backend(file, plan, reader_pes, opts,
                                              ropts)
            finally:
                # Always released — an exception above would otherwise
                # deadlock every future sequenced session start.
                if sequenced:
                    self._sequence_lock.release()

            # Broadcast to the Manager group; last ack fires `ready`.
            acks = {"n": 0}
            npes = self.sched.num_pes

            def make_register(pe: int) -> Callable[[], None]:
                def register() -> None:
                    self.managers[pe].register_session(session)
                    acks["n"] += 1
                    if acks["n"] == npes:
                        ready.send(self.sched, session)

                return register

            self.sched.enqueue_many(
                ((pe, make_register(pe)) for pe in range(npes)),
                label="ckio-bcast",
            )

        self.sched.enqueue(0, do_start, label="ckio-start-session")

    def close_session(self, session: Session, after: CkCallback) -> None:
        def do_close() -> None:
            for observe in self._observers:
                observe(session.metrics)
            self.locality.merge(session.readers.locality)
            session.readers.cancel()
            # Enforce the borrowed-view contract: views handed out by
            # read(dest=None) die with the session.
            session.readers.invalidate_borrows()
            # Backend teardown (no-op for threads; the process backend
            # joins its supervisor and unmaps the shm segments here).
            session.readers.release()
            # Merge AFTER release: the process backend's worker I/O
            # counters are folded into the session metrics by its
            # supervisor teardown, which release() joins.
            self.recovery.merge(session.metrics.recovery)
            session.closed = True
            with self._lock:
                self.sessions.pop(session.id, None)
            acks = {"n": 0}
            npes = self.sched.num_pes

            def make_forget(pe: int) -> Callable[[], None]:
                def forget() -> None:
                    self.managers[pe].forget_session(session.id)
                    acks["n"] += 1
                    if acks["n"] == npes:
                        after.send(self.sched)

                return forget

            self.sched.enqueue_many(
                ((pe, make_forget(pe)) for pe in range(npes)),
                label="ckio-close-bcast",
            )

        self.sched.enqueue(0, do_close, label="ckio-close-session")

    # -- session construction --------------------------------------------------
    def _start_backend(self, file: FileHandle, plan, reader_pes: List[int],
                       opts: FileOptions, ropts) -> Session:
        """Backend dispatch: helper threads, or worker processes over a
        shared-memory arena (``core/buffers.py`` ``ProcessReaderSet``), or
        an attached reader service's pool (:meth:`_build_session`).

        Graceful degradation is opt-in: with ``fallback_backend="thread"``
        a process-backend *setup* failure (spawn rejecting an unpicklable
        hook, shm exhaustion) rebuilds the session on the thread backend
        instead of failing it, with one ``RuntimeWarning`` per
        ``FileOptions`` and ``recovery.degraded_mode`` set on every such
        session; a ``FileOptions`` that fell back stays on threads (no
        re-attempt, no re-warning). Worker crashes after the start are the
        recovery layer's job (``FileOptions.recovery``), not this one's."""
        degraded = (ropts.backend == "process"
                    and getattr(opts, "_fallback_active", False))
        if degraded:
            ropts = dataclasses.replace(ropts, backend="thread")
        try:
            session = self._build_session(file, plan, reader_pes, opts,
                                          ropts)
        except Exception as exc:
            if (ropts.backend != "process"
                    or opts.fallback_backend != "thread"):
                raise
            if not getattr(opts, "_warned_fallback", False):
                opts._warned_fallback = True
                warnings.warn(
                    f"process reader backend failed at session start "
                    f"({exc}); falling back to backend='thread' for this "
                    f"file (degraded mode)", RuntimeWarning)
            opts._fallback_active = True
            degraded = True
            ropts = dataclasses.replace(ropts, backend="thread")
            session = self._build_session(file, plan, reader_pes, opts,
                                          ropts)
        if degraded:
            session.metrics.recovery.mark_degraded()
        return session

    def _build_session(self, file: FileHandle, plan, reader_pes: List[int],
                       opts: FileOptions, ropts) -> Session:
        """Service routing. With a ReaderService attached, process-backend
        sessions run on the pool; a saturated service (``ServiceBusy`` at
        admission) falls back to per-session spawn when
        ``FileOptions.use_service`` is left at auto (None) and surfaces to
        the caller when the session was pinned (True)."""
        if (self.service is not None and ropts.backend == "process"
                and opts.use_service is not False):
            from repro_torch.ipc.service import ServiceBusy
            try:
                return self._construct_session(
                    file, plan, reader_pes, opts, ropts,
                    service=self.service)
            except ServiceBusy:
                if opts.use_service:
                    raise
                # Auto mode: admission queue full — this session pays the
                # per-session spawn instead of waiting behind the pool.
        return self._construct_session(file, plan, reader_pes, opts, ropts)

    def _construct_session(self, file: FileHandle, plan,
                           reader_pes: List[int], opts: FileOptions, ropts,
                           service=None) -> Session:
        """Allocate an id, construct the reader set for ``ropts.backend``
        (or the attached service), register and start it. On any failure
        the half-created session is scrubbed from the tables and backend
        resources released before the exception propagates (so a fallback
        retry starts clean)."""
        with self._lock:
            sid = next(self._session_ids)
        readers = None
        try:
            if service is not None:
                from repro_torch.ipc.service import ServiceReaderSet
                readers = ServiceReaderSet(file.posix, plan, self.sched,
                                           reader_pes, ropts,
                                           service=service,
                                           tenant=opts.tenant)
            else:
                reader_cls = (ProcessReaderSet if ropts.backend == "process"
                              else BufferReaderSet)
                readers = reader_cls(file.posix, plan, self.sched,
                                     reader_pes, ropts)
            session = Session(
                id=sid,
                file=file,
                plan=plan,
                readers=readers,
                opts=opts,
                reader_pes=reader_pes,
                metrics=readers.metrics,
            )
            with self._lock:
                self.sessions[sid] = session
            # Greedy prefetch begins NOW — before any client request
            # exists.
            readers.start()
            return session
        except BaseException:
            with self._lock:
                self.sessions.pop(sid, None)
            if readers is not None:
                readers.release()
            raise
