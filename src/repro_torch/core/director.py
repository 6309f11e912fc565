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

import itertools
import threading
from typing import Callable, Dict, List, Optional

from repro_torch.core.assembler import ReadAssembler
from repro_torch.core.buffers import BufferReaderSet
from repro_torch.core.futures import CkCallback
from repro_torch.core.metrics import RecoveryMetrics, SessionMetrics
from repro_torch.core.placement import place_readers
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.core.session import FileHandle, FileOptions, Session
from repro_torch.io.layout import plan_session
from repro_torch.io.posix import DEFAULT_ALIGN, PosixFile


def suggest_num_readers(
    file_bytes: int,
    num_pes: int,
    num_nodes: int = 1,
    target_chunk_bytes: int = 64 * 1024 * 1024,
) -> int:
    """Reader count for a session of ``file_bytes`` when ``num_readers`` is
    unset: one reader per ``target_chunk_bytes``, at least one per node,
    at most two per PE (paper Fig. 4: beyond ~2/PE only adds contention)."""
    if file_bytes <= 0:
        return 1
    by_chunk = max(1, (file_bytes + target_chunk_bytes - 1) // target_chunk_bytes)
    lo = max(1, num_nodes)
    hi = max(lo, 2 * num_pes)
    return int(min(max(by_chunk, lo), hi))


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
        # Session-close observers: each finished session's metrics are fed
        # to every registered observer (extend with ``add_observer``).
        self._observers: List[Callable[[SessionMetrics], None]] = []
        # Director-lifetime I/O-retry aggregate (merged on session close).
        self.recovery = RecoveryMetrics()

    def add_observer(self, observe: Callable[[SessionMetrics], None]) -> None:
        """Register a session-close observer (it receives every finished
        session's ``SessionMetrics``)."""
        self._observers.append(observe)

    # -- files ---------------------------------------------------------------
    def open_file(
        self, path: str, opts: FileOptions, opened: CkCallback
    ) -> None:
        def do_open() -> None:
            posix = PosixFile.open(path)
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
            sharded = fileset.sharded_file()
            with self._lock:
                fid = next(self._file_ids)
                handle = FileHandle(id=fid, path=sharded.path, posix=sharded,
                                    opts=opts)
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

        def do_start() -> None:
            if sequenced:
                # Global coordination (paper §III-C.1): serialize the greedy
                # read kick-off of concurrent sessions on distinct files.
                self._sequence_lock.acquire()
            try:
                plan = plan_session(
                    offset, nbytes, num_readers,
                    splinter_bytes=opts.splinter_bytes,
                    align=getattr(file.posix, "block_size", DEFAULT_ALIGN),
                )
                reader_pes = place_readers(
                    opts.placement, plan.num_readers, self.sched,
                    consumer_pes,
                )
                session = self._construct_session(
                    file, plan, reader_pes, opts, ropts)
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
            session.readers.cancel()
            # Enforce the borrowed-view contract: views handed out by
            # read(dest=None) die with the session.
            session.readers.invalidate_borrows()
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
    def _construct_session(self, file: FileHandle, plan,
                           reader_pes: List[int], opts: FileOptions,
                           ropts) -> Session:
        """Allocate an id, construct the thread-backend reader set, register
        and start it. On failure the half-created session is scrubbed from
        the tables before the exception propagates."""
        with self._lock:
            sid = next(self._session_ids)
        try:
            readers = BufferReaderSet(file.posix, plan, self.sched,
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
            raise
