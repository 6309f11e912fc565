"""CkIO public API — the paper's §III-D interface, adapted to Python.

The five split-phase operations mirror the paper exactly:

    ckio.open(name, opened_cb, opts)            Ck::IO::open
    ckio.start_read_session(file, bytes,
                            offset, ready_cb)   Ck::IO::startReadSession
    ckio.read(session, bytes, offset,
              data, after_read_cb)              Ck::IO::read
    ckio.close_read_session(session, cb)        Ck::IO::closeReadSession
    ckio.close(file, cb)                        Ck::IO::close

Every callback is *enqueued as a task* on its target PE (or routed through a
migratable client's virtual proxy) — no operation blocks a PE. Futures-based
sugar (``open_sync``, ``read_future``, ...) is provided for driver code and
tests; the futures pump the scheduler, preserving split-phase semantics.

Streaming (per-splinter completion events)
------------------------------------------
``read_stream(session, on_splinter, ...)`` subscribes to the session's
splinter completion stream: one callback per completed splinter read (with
arrival metadata), delivered as scheduler tasks — optionally routed through
a consumer's virtual proxy with drop-stale semantics. It is the primitive
under the pipeline's streamed host→device staging (``data/pipeline.py``,
``streaming=True``); ``end_stream`` unsubscribes.

Zero-copy reads (borrowed views)
--------------------------------
``read(..., data=None)`` / ``read_view(...)`` select the zero-copy delivery
path: ``after_read`` receives a **read-only memoryview into the session
arena** instead of a filled buffer (§III-C.4's zero-copy buffer→assembler
hand-off). Lifetime contract:

* the view is a *session-lifetime borrow* — it stays valid exactly until
  ``close_read_session`` on its session, at which point the library releases
  it and any later access raises ``ValueError`` (no silent reads of recycled
  memory);
* copy out (or stage to the device) anything needed past session close;
* the view is read-only; sub-views you slice off share the same lifetime by
  contract (slicing is not re-tracked — don't outlive the session).

The delivered-byte copy count is observable: ``session.metrics.bytes_copied``
stays 0 for view-path deliveries.

Tuning knobs (``FileOptions``)
------------------------------
* ``num_readers`` — parallel stripe readers (autotuned when ``None``);
* ``splinter_bytes`` — unit of physical I/O / early fulfilment (§VI-C);
* ``work_stealing`` — straggler mitigation between reader threads;
* ``placement`` — reader→PE mapping policy (``core/placement.py``);
* ``network`` — optional cross-node transfer model for locality studies.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Union

from repro_torch.core.director import Director
from repro_torch.core.futures import CkCallback, CkFuture
from repro_torch.core.migration import Client, LocationManager
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.core.session import FileHandle, FileOptions, Session


def _to_cb(cb: Union[CkCallback, CkFuture, None], default_pe: int = 0) -> CkCallback:
    if isinstance(cb, CkCallback):
        return cb
    if isinstance(cb, CkFuture):
        wrapped = CkCallback(lambda *a: cb.set(a[0] if a else None),
                             inline=True)
        # Error channel for the assembler: a session failure (process
        # backend worker crash) is routed to ``set_error`` on the future
        # itself, so ``wait`` raises the descriptive error instead of
        # timing out.
        wrapped.future = cb
        return wrapped
    if cb is None:
        return CkCallback(lambda *a: None, inline=True)
    raise TypeError(f"expected CkCallback/CkFuture/None, got {type(cb)}")


class CkIO:
    """Library facade: one instance per 'job' (owns scheduler + director)."""

    def __init__(
        self,
        num_pes: int = 1,
        pes_per_node: int = 1,
        sched: Optional[TaskScheduler] = None,
    ):
        self.sched = sched or TaskScheduler(num_pes, pes_per_node)
        self.director = Director(self.sched)
        self.locations = LocationManager(self.sched)

    # -- paper API (split-phase) ------------------------------------------------
    def open(
        self,
        name: str,
        opened: Union[CkCallback, CkFuture, None] = None,
        opts: Optional[FileOptions] = None,
    ) -> None:
        self.director.open_file(name, opts or FileOptions(), _to_cb(opened))

    def open_fileset(
        self,
        fileset,
        opened: Union[CkCallback, CkFuture, None] = None,
        opts: Optional[FileOptions] = None,
    ) -> None:
        """Open a multi-shard manifest (``repro_torch.data.fileset.FileSet``)
        as ONE logical file. The returned ``FileHandle`` addresses the
        manifest's global data byte space (shard data regions concatenated,
        header pages excluded, byte 0 = row 0); sessions, ``read``/
        ``read_stream``/subscribe, zero-copy views and both reader backends
        work unchanged — stripe planning pins shard starts as hard bounds so
        no physical read spans a shard, and process-backend workers rebuild
        the shard table from paths (never inherited fds).
        ``opts.direct_io`` opens every shard ``O_DIRECT``."""
        self.director.open_fileset(fileset, opts or FileOptions(),
                                   _to_cb(opened))

    def start_read_session(
        self,
        file: FileHandle,
        nbytes: int,
        offset: int,
        ready: Union[CkCallback, CkFuture, None] = None,
        consumer_pes: Optional[List[int]] = None,
        sequenced: bool = False,
    ) -> None:
        self.director.start_session(
            file, nbytes, offset, _to_cb(ready), consumer_pes, sequenced
        )

    def read(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        data: Any,
        after_read: Union[CkCallback, CkFuture, None],
        client: Optional[Client] = None,
    ) -> None:
        """Split-phase read of ``[offset, offset+nbytes)`` into ``data``.

        ``offset`` is absolute within the file (the paper's API takes offsets
        "with respect to the overall file the session corresponds to").
        If ``client`` is given, completion is routed through its virtual proxy
        (survives migration) and the request is assembled on the client's
        *current* PE.

        ``data=None`` selects the zero-copy borrowed-view path: the completion
        message's ``.data`` is a read-only memoryview into the session arena,
        valid until ``close_read_session`` (see module docstring for the full
        lifetime contract).
        """
        if session.closed:
            raise RuntimeError("read() on closed session")
        if not session.contains(offset, nbytes):
            raise ValueError(
                f"read [{offset}, {offset+nbytes}) outside session "
                f"[{session.offset}, {session.offset+session.nbytes})"
            )
        cb = _to_cb(after_read)
        if client is not None and cb.inline is False and cb.proxy is None:
            # prefer proxy routing when a client is identified
            cb = client.callback(cb.fn)
        pe = client.pe if client is not None else 0
        assembler = self.director.managers[pe].assembler
        assembler.submit(session, offset, nbytes, data, cb)

    def close_read_session(
        self,
        session: Session,
        after_end: Union[CkCallback, CkFuture, None] = None,
    ) -> None:
        self.director.close_session(session, _to_cb(after_end))

    def close(
        self, file: FileHandle, closed: Union[CkCallback, CkFuture, None] = None
    ) -> None:
        self.director.close_file(file, _to_cb(closed))

    # -- futures sugar ------------------------------------------------------------
    def open_sync(
        self, name: str, opts: Optional[FileOptions] = None, timeout: float = 60.0
    ) -> FileHandle:
        f: CkFuture = CkFuture()
        self.open(name, f, opts)
        return f.wait(self.sched, timeout=timeout)

    def open_fileset_sync(
        self, fileset, opts: Optional[FileOptions] = None,
        timeout: float = 60.0,
    ) -> FileHandle:
        f: CkFuture = CkFuture()
        self.open_fileset(fileset, f, opts)
        return f.wait(self.sched, timeout=timeout)

    def start_read_session_sync(
        self,
        file: FileHandle,
        nbytes: int,
        offset: int = 0,
        timeout: float = 60.0,
        **kw: Any,
    ) -> Session:
        f: CkFuture = CkFuture()
        self.start_read_session(file, nbytes, offset, f, **kw)
        return f.wait(self.sched, timeout=timeout)

    def read_view(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        after_read: Union[CkCallback, CkFuture, None],
        client: Optional[Client] = None,
    ) -> None:
        """Zero-copy split-phase read: ``after_read`` gets a session-lifetime
        read-only view (sugar for ``read(..., data=None)``)."""
        self.read(session, nbytes, offset, None, after_read, client=client)

    def read_notify(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        after_read: Union[CkCallback, CkFuture, None],
        client: Optional[Client] = None,
        classify_locality: bool = True,
    ) -> None:
        """Residency signal only: like ``read_view`` but the completion
        message carries ``data=None`` and no borrow is created — for callers
        that will take their own arena view later (e.g. once per batch
        rather than once per consumer). ``classify_locality=False`` keeps
        this request out of the same-/cross-domain byte accounting (for
        callers whose bytes are classified on another path — see
        ``ReadAssembler.submit``)."""
        if session.closed:
            raise RuntimeError("read_notify() on closed session")
        if not session.contains(offset, nbytes):
            raise ValueError(
                f"read [{offset}, {offset+nbytes}) outside session "
                f"[{session.offset}, {session.offset+session.nbytes})"
            )
        cb = _to_cb(after_read)
        if client is not None and cb.inline is False and cb.proxy is None:
            cb = client.callback(cb.fn)
        pe = client.pe if client is not None else 0
        self.director.managers[pe].assembler.submit(
            session, offset, nbytes, None, cb, materialize_view=False,
            classify_locality=classify_locality,
        )

    def read_stream(
        self,
        session: Session,
        on_splinter: Callable,
        *,
        client: Optional[Client] = None,
        route: Optional[Callable] = None,
        pe: int = 0,
        on_complete: Optional[Callable[[], None]] = None,
        replay: bool = True,
    ) -> int:
        """Subscribe to ``session``'s per-splinter completion stream.

        The event-driven counterpart of ``read``: instead of waiting for a
        byte range, the caller is invoked once per **splinter** as its read
        completes, with a ``SplinterEvent`` (splinter id, owning reader,
        absolute offset, size, arena offset, arrival timestamp). This is the
        primitive a streaming consumer (e.g. the pipeline's host→device
        stager) builds on: data can be shipped onward while the rest of the
        session is still being read.

        Split-phase like everything else: ``on_splinter`` is *enqueued as a
        task*, never run on the I/O thread. Routing, in precedence order:

        * ``route`` — callable ``SplinterEvent -> Optional[Client]``; the
          event is delivered through the returned client's virtual proxy
          with **drop-stale** semantics (a retired/deregistered consumer's
          events are dropped and counted in
          ``locations.stale_deliveries``, never rerouted to a reused
          slot); ``route`` returning ``None`` falls back to ``pe``.
        * ``client`` — fixed client, same drop-stale proxy delivery.
        * ``pe`` — fixed PE (default 0).

        With ``replay=True`` splinters that completed before the call are
        delivered first (in arrival order) — subscribing after the greedy
        prefetch started misses nothing. ``on_complete`` (optional) is
        enqueued on ``pe`` after the last splinter's delivery has been
        issued; it requires ``replay=True`` (without replay, splinters that
        completed before the subscription are never delivered, so the count
        could never reach the total and the callback would silently never
        fire). Returns a token for ``end_stream``.
        """
        if session.closed:
            raise RuntimeError("read_stream() on closed session")
        if on_complete is not None and not replay:
            raise ValueError("on_complete requires replay=True (completions "
                             "before the subscription would never be counted)")
        total = len(session.plan.splinters)
        state = {"n": 0}
        lock = threading.Lock()
        topo = session.opts.topology

        def deliver(ev) -> None:
            target = route(ev) if route is not None else client
            if topo is not None:
                # Streamed counterpart of the assembler's per-piece
                # classification: streamed bytes are classified against
                # the domain of the consumer each event is routed to (the
                # pipeline's whole-window residency probe opts out with
                # classify_locality=False, so nothing is counted twice).
                # Classified at issue time (a drop-stale discard later
                # still counts as routed bytes).
                dest_pe = target.pe if target is not None else pe
                session.readers.locality.record_delivery(
                    ev.nbytes,
                    session.readers.reader_domain(ev.reader)
                    == topo.domain_of(dest_pe))
            if target is not None:
                target.callback(on_splinter, drop_stale=True).send(
                    self.sched, ev)
            else:
                self.sched.enqueue(pe, on_splinter, ev, label="ckio-stream")
            if on_complete is not None:
                with lock:
                    state["n"] += 1
                    last = state["n"] == total
                if last:
                    self.sched.enqueue(pe, on_complete,
                                       label="ckio-stream-end")

        return session.subscribe_splinters(deliver, replay=replay)

    def end_stream(self, session: Session, token: int) -> None:
        """Unsubscribe a ``read_stream`` token (barrier: no further
        deliveries are *issued* once this returns; tasks already enqueued
        still run — guard the consumer, see the pipeline's retired check)."""
        session.unsubscribe_splinters(token)

    def read_future(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        data: Optional[Any] = None,
        client: Optional[Client] = None,
    ) -> CkFuture:
        if data is None:
            data = bytearray(nbytes)
        f: CkFuture = CkFuture()
        self.read(session, nbytes, offset, data, f, client=client)
        return f

    def read_view_future(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        client: Optional[Client] = None,
    ) -> CkFuture:
        f: CkFuture = CkFuture()
        self.read_view(session, nbytes, offset, f, client=client)
        return f

    def read_view_sync(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        client: Optional[Client] = None,
        timeout: float = 120.0,
    ) -> memoryview:
        """Blocking zero-copy read; the returned view dies with the session."""
        f = self.read_view_future(session, nbytes, offset, client)
        return f.wait(self.sched, timeout=timeout).data

    def read_sync(
        self,
        session: Session,
        nbytes: int,
        offset: int,
        data: Optional[Any] = None,
        client: Optional[Client] = None,
        timeout: float = 120.0,
    ) -> Any:
        f = self.read_future(session, nbytes, offset, data, client)
        return f.wait(self.sched, timeout=timeout).data

    def session_arrival_order(self, session: Session):
        """Per-session piece (splinter) arrival order — the completion order
        the reader layer observed. Feeds the device-ingest index-map
        construction (``data.packing.pieces_in_arrival_order``); a snapshot,
        stable once the session's reads are complete."""
        return session.arrival_order

    def close_read_session_sync(self, session: Session, timeout: float = 60.0) -> None:
        f: CkFuture = CkFuture()
        self.close_read_session(session, f)
        f.wait(self.sched, timeout=timeout)

    def close_sync(self, file: FileHandle, timeout: float = 60.0) -> None:
        f: CkFuture = CkFuture()
        self.close(file, f)
        f.wait(self.sched, timeout=timeout)

    # -- clients ------------------------------------------------------------------
    def make_client(self, pe: int = 0) -> Client:
        return Client(self.locations, pe)

    # -- scheduler passthrough ------------------------------------------------------
    def pump(self, max_tasks: Optional[int] = None) -> int:
        return self.sched.pump(max_tasks)

    def run_until(self, predicate, *, timeout: float = 60.0) -> None:
        self.sched.run_until(predicate, timeout=timeout)
