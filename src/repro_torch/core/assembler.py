"""ReadAssembler: per-PE request fulfilment (paper §III-C.3).

All read requests from clients on a given PE are handled by that PE's
assembler. A request may span multiple buffer readers; the assembler splits
it into pieces, registers availability waiters with the reader set, and as
pieces land copies them into the client's destination buffer *on the client's
PE* (as a scheduled task — never inline from an I/O thread). When the last
piece arrives it fires the user's ``after_read`` callback, which Charm++ would
deliver as an asynchronous method invocation and we deliver as a scheduler
task routed through the client's virtual proxy (so it survives migration).

Hot-path structure (this is the per-piece cost every delivered byte pays):

* pieces are **coalesced by (node, memory domain)**
  (``pieces_for_range(coalesce_key=...)``): contiguous stripes whose
  readers share a scheduler node AND a NUMA domain (without a
  ``Topology``, just the node) merge into one piece — one waiter, one
  scheduled task, one copy — since the session arena is directly
  addressable within a node (Thakur-style request merging). Domain
  granularity keeps each merged piece's bytes on one memory controller,
  so a same-domain assembler touches only local memory; with a topology,
  cross- vs same-domain delivered bytes are tracked per session in
  ``LocalityMetrics`` (the counter NUMA-aware placement is judged by).
* ``dest=None`` selects the **borrowed-view** path (paper §III-C.4's
  zero-copy buffer→assembler hand-off): ``after_read`` receives a read-only
  ``memoryview`` into the session arena instead of a filled buffer. The view
  is a *session-lifetime borrow* — it is invalidated (released) by
  ``close_read_session``; copy out anything needed beyond that.
* per-piece wall timing runs only when ``metrics.should_time_piece()`` says
  so (sampled/off by default), keeping instrumentation off the hot path.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.futures import CkCallback
from repro_torch.core.metrics import SessionMetrics
from repro_torch.core.scheduler import TaskScheduler
from repro_torch.io.layout import pieces_for_range


@dataclass
class ReadComplete:
    """Message delivered to ``after_read`` (paper: read completion msg).

    ``data`` is the destination buffer passed to ``read()``, or — on the
    borrowed-view path (``dest=None``) — a read-only memoryview into the
    session arena, valid until the session closes.
    """

    offset: int
    nbytes: int
    data: Any
    session_id: int
    latency_s: float


class _RequestState:
    __slots__ = ("outstanding", "lock", "t0", "failed")

    def __init__(self, n: int):
        self.outstanding = n
        self.lock = threading.Lock()
        self.t0 = time.perf_counter()
        self.failed = False

    def piece_done(self) -> bool:
        with self.lock:
            self.outstanding -= 1
            return self.outstanding == 0 and not self.failed

    def mark_failed(self) -> bool:
        """First piece-waiter to report a session failure wins — the
        request surfaces its error exactly once."""
        with self.lock:
            first = not self.failed
            self.failed = True
            return first


def _as_byteview(buf: Any) -> memoryview:
    mv = memoryview(buf)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if mv.readonly:
        raise ValueError("read() destination buffer must be writable")
    return mv


class ReadAssembler:
    """One per PE (a chare-group member in the paper)."""

    def __init__(self, sched: TaskScheduler, pe: int):
        self.sched = sched
        self.pe = pe

    def submit(
        self,
        session: "Session",  # noqa: F821 (circular; duck-typed)
        abs_off: int,
        nbytes: int,
        dest: Any,
        after_read: CkCallback,
        metrics: Optional[SessionMetrics] = None,
        materialize_view: bool = True,
        classify_locality: bool = True,
    ) -> None:
        """Fulfil one client request.

        ``dest=None`` is the zero-copy path; with ``materialize_view=False``
        the completion message carries ``data=None`` (residency signal only —
        no borrow is created or tracked), for callers that will view the
        arena themselves later. ``classify_locality=False`` skips the
        same-/cross-domain LocalityMetrics accounting for this request —
        used by callers whose delivered bytes are classified elsewhere
        (the streaming pipeline's whole-window residency probe, whose
        bytes the splinter stream already classifies per event)."""
        readers = session.readers
        plan = session.plan
        zero_copy = dest is None
        dest_view: Optional[memoryview] = None
        if not zero_copy:
            dest_view = _as_byteview(dest)
            if len(dest_view) < nbytes:
                raise ValueError(
                    f"destination buffer too small: {len(dest_view)} < {nbytes}"
                )
        metrics = metrics or session.metrics
        # Coalesce by (node, NUMA domain) when a topology is configured
        # (plain node otherwise): merged pieces never span a memory domain
        # *or* a scheduler node — a merged piece is attributed to its
        # first reader, so both the NetworkModel decision and the domain
        # classification below stay correct for the whole piece.
        pieces = pieces_for_range(
            plan, abs_off, nbytes, coalesce_key=readers.reader_locality
        )
        state = _RequestState(len(pieces))

        def fail_request(exc: BaseException) -> None:
            """Session died before this request's data landed (process
            backend worker crash): surface the error exactly once per
            request — through the caller's future when there is one
            (``read_sync`` and friends raise it from their wait).
            Future-less requests (plain callbacks, ``read_notify``) share
            ONE raising task per session (``claim_error_surface``): it
            unblocks the waiting pump, and capping it keeps failed
            fan-outs from littering the queue with tasks that would
            re-raise out of unrelated later pumps."""
            if not state.mark_failed():
                return
            fut = getattr(after_read, "future", None)
            if fut is not None:
                fut.set_error(exc)
                return
            if not session.readers.claim_error_surface():
                return

            def raise_error() -> None:
                raise exc

            self.sched.enqueue(self.pe, raise_error, label="ckio-read-error")

        net = session.opts.network
        my_node = self.sched.node_of(self.pe)
        topo = session.opts.topology
        # Domain classification (LocalityMetrics) only runs with a
        # topology: without one it would duplicate record_piece's
        # cross-node counter at an extra lock acquisition per piece on
        # the delivery hot path.
        my_domain = (topo.domain_of(self.pe)
                     if topo is not None and classify_locality else None)

        def finish() -> None:
            lat = time.perf_counter() - state.t0
            metrics.record_request(lat)
            if zero_copy:
                data = (readers.borrow_view(abs_off, nbytes)
                        if materialize_view else None)
            else:
                data = dest
            msg = ReadComplete(
                offset=abs_off,
                nbytes=nbytes,
                data=data,
                session_id=session.id,
                latency_s=lat,
            )
            after_read.send(self.sched, msg)

        def make_piece_handler(reader: int, p_off: int, p_len: int):
            dst_lo = p_off - abs_off
            cross = readers.reader_node(reader) != my_node
            cross_domain = (my_domain is not None
                            and readers.reader_domain(reader) != my_domain)

            def deliver_on_pe() -> None:
                timed = metrics.should_time_piece()
                t0 = time.perf_counter() if timed else 0.0
                copied = 0
                if not zero_copy:
                    src = readers.view(p_off, p_len)
                    dest_view[dst_lo : dst_lo + p_len] = src
                    copied = p_len
                metrics.record_piece(
                    p_len,
                    cross,
                    (time.perf_counter() - t0) if timed else None,
                    copied=copied,
                    borrowed=zero_copy,
                )
                if my_domain is not None:
                    readers.locality.record_delivery(p_len, not cross_domain)
                if state.piece_done():
                    finish()

            def on_available() -> None:
                # Runs on an I/O thread (or inline if data already resident):
                # model the buffer→client transfer, then enqueue the delivery
                # as a task on this PE. Borrowed-view (zero-copy) pieces skip
                # the model: the client receives a view of the arena — same
                # address space, or the mapped shm segment under the process
                # backend — so no bytes cross a node; modeling a transfer
                # AND reporting a zero-copy delivery would double-count the
                # piece (its locality lands in cross_node_view_bytes).
                enqueue = lambda: self.sched.enqueue(  # noqa: E731
                    self.pe, deliver_on_pe, label="ckio-piece"
                )
                if net is not None and not zero_copy:
                    net.deliver(p_len, not cross, enqueue)
                else:
                    enqueue()

            return on_available

        if not pieces:
            # Zero-length read: still split-phase — complete via the queue.
            self.sched.enqueue(self.pe, finish, label="ckio-piece")
            return
        # Batch the resident-data case: pieces already in the arena fire
        # inline here, and the batch turns their enqueues into one
        # lock/notify round.
        with self.sched.batch():
            for reader, p_off, p_len in pieces:
                readers.when_available(
                    p_off, p_len, make_piece_handler(reader, p_off, p_len),
                    on_error=fail_request,
                )
