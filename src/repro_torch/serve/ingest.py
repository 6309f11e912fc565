"""Request ingest under session churn: one short-lived CkIO session per
request, with explicit backpressure.

The :class:`RequestIngester` is the serving front door. Each submitted
:class:`ServeRequest` names a prompt span (rows of a token file / FileSet);
the ingester opens a read session for exactly that span, issues one
zero-copy ``read_view``, and surfaces the request as *ready* once the
borrowed view has landed — the millions-of-users regime of the paper's
consumer/reader decoupling: session lifetime shrinks from "the whole
training run" to "one request's queueing time".

A shared reader service (``service=``) comes with the reader service slice
(ROADMAP.md, Queue A); until then ``ServiceBusy`` is this module's own
class (raised by no reader tier yet).

Everything is poll-driven and single-threaded (the split-phase idiom):
``submit`` never blocks on I/O, ``poll`` pumps the scheduler, advances
per-request state machines, and returns newly ready requests. The decode
loop calls ``poll`` between steps, so ingest overlaps decode the same way
the paper overlaps read with compute.

Session lifetime per request
----------------------------
    submit -> (queued) -> session open + read_view issued   [ingesting]
           -> view delivered                                 [ready]
           -> decode engine consumes the prompt at admission; the borrowed
              view dies HERE (``release``: refs dropped, session closed,
              arena back to the service pool)                [decoding]
           -> EOS / max-tokens eviction                      [done]

The borrowed prompt view is session-lifetime, NOT slot-lifetime: it is
consumed during ``engine.admit`` and released before decode continues, so
slot eviction never touches CkIO state and a session is open only while
its bytes are actually needed (keeping churn high and arena-pool pressure
low). Nothing may retain ``req.prompt`` past admission — a pinned export
would force the service to quarantine the arena segment instead of
recycling it.

Backpressure: when ``ServeOverloaded`` surfaces vs queues
---------------------------------------------------------
Two triggers, one bounded queue, never a stall of the decode loop:

  * the shared reader service raises ``ServiceBusy`` (admission caps
    hit; none in the port yet), or
  * inflight ingest bytes (open prompt sessions) would exceed
    ``max_inflight_bytes``.

Either trigger moves the ingester ``open -> queueing``: new submits join a
bounded FIFO (depth ``max_pending``) and are retried on every poll — a
queued request IS admitted and is never dropped. Only when that queue is
full does a *new* submit fail fast with a descriptive
:class:`ServeOverloaded` (``queueing -> shedding``); the caller sees the
rejection synchronously and the decode loop never waits on a saturated
reader tier. Draining the queue walks the states back down
(``shedding -> queueing -> open``); every transition is counted in
:class:`~repro_torch.core.metrics.ServeMetrics`.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core.futures import CkFuture
from repro_torch.core.metrics import ServeMetrics


class ServiceBusy(RuntimeError):
    """The shared reader tier is at its admission cap (the reference's
    ``repro.ipc.service.ServiceBusy``); the ingester queues the request."""


class ServeOverloaded(RuntimeError):
    """The ingest queue is full on top of a saturated reader tier; the
    submit was rejected (NOT admitted). Retry later or scale the service."""


@dataclass
class ServeRequest:
    """One serving request: a prompt span plus decode limits.

    ``file`` optionally overrides the ingester's default handle (e.g. a
    handle opened with fault injection or different recovery options);
    ``arrival_t`` may be preset by a load generator replaying a trace.
    """

    rid: int
    row_start: int
    num_rows: int
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    file: Optional[Any] = None

    # -- runtime (owned by the ingester / batcher) ----------------------------
    status: str = "new"          # new|queued|ingesting|ready|decoding|done|failed
    prompt: Optional[np.ndarray] = None   # borrowed view; dies at admission
    result: Optional[List[int]] = None
    error: Optional[BaseException] = None
    arrival_t: float = 0.0
    t_ingested: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    _offset: int = 0
    _nbytes: int = 0
    _session: Any = field(default=None, repr=False)
    _view_fut: Optional[CkFuture] = field(default=None, repr=False)


class RequestIngester:
    """Admit a stream of requests through short-lived CkIO sessions (module
    docstring has the lifecycle and backpressure contracts)."""

    def __init__(
        self,
        ck: Any,
        file: Any,
        meta: Any,                       # TokenFileMeta / FileSet surface
        metrics: Optional[ServeMetrics] = None,
        *,
        max_pending: int = 64,
        max_inflight_bytes: int = 256 << 20,
        service: Any = None,
        start_timeout_s: float = 60.0,
    ):
        if service is not None:
            raise NotImplementedError(
                "RequestIngester(service=...): the pooled ReaderService comes "
                "with the reader service slice (ROADMAP.md, Queue A)")
        self.ck = ck
        self.file = file
        self.meta = meta
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.max_pending = max_pending
        self.max_inflight_bytes = max_inflight_bytes
        self.start_timeout_s = start_timeout_s
        self._queued: Deque[ServeRequest] = deque()
        self._ingesting: List[ServeRequest] = []
        self._closing: List[Tuple[CkFuture, int]] = []
        self._inflight_bytes = 0
        self.failed: List[ServeRequest] = []

    # -- admission -------------------------------------------------------------
    def submit(self, req: ServeRequest) -> ServeRequest:
        """Admit ``req`` (start its ingest session now, or queue it under
        backpressure). Raises :class:`ServeOverloaded` — and does NOT admit
        — when the bounded queue is already full."""
        now = time.perf_counter()
        if req.arrival_t == 0.0:
            req.arrival_t = now
        self.metrics.record_submitted(now)
        req._offset, req._nbytes = self.meta.byte_range_for_rows(
            req.row_start, req.num_rows)
        # FIFO fairness: never let a fresh submit overtake the queue.
        if not self._queued and self._try_start(req):
            self.metrics.record_accepted()
            return req
        if len(self._queued) >= self.max_pending:
            self.metrics.record_shed()
            self.metrics.set_state("shedding")
            raise ServeOverloaded(
                f"request {req.rid} shed: ingest queue full at "
                f"{self.max_pending} on top of a saturated reader tier "
                f"({self._inflight_bytes} inflight ingest bytes, budget "
                f"{self.max_inflight_bytes}); retry later, raise "
                f"max_pending/max_inflight_bytes, or scale the service")
        req.status = "queued"
        self._queued.append(req)
        self.metrics.record_accepted()
        self.metrics.record_queue_depth(len(self._queued))
        self.metrics.set_state(
            "shedding" if len(self._queued) >= self.max_pending
            else "queueing")
        return req

    def _try_start(self, req: ServeRequest) -> bool:
        """Open ``req``'s session + issue its zero-copy read. ``False`` =
        backpressured (budget or ServiceBusy) — the caller queues/keeps it."""
        if self._inflight_bytes + req._nbytes > self.max_inflight_bytes:
            self.metrics.record_over_budget()
            return False
        fh = req.file if req.file is not None else self.file
        try:
            sess = self.ck.start_read_session_sync(
                fh, req._nbytes, req._offset, timeout=self.start_timeout_s)
        except ServiceBusy:
            self.metrics.record_busy()
            return False
        req._session = sess
        req._view_fut = self.ck.read_view_future(
            sess, req._nbytes, req._offset)
        req.status = "ingesting"
        self._ingesting.append(req)
        self._inflight_bytes += req._nbytes
        self.metrics.record_inflight_bytes(self._inflight_bytes)
        return True

    # -- the poll loop ---------------------------------------------------------
    def poll(self) -> List[ServeRequest]:
        """Advance every in-flight ingest; returns newly *ready* requests
        (prompt view delivered). Non-blocking."""
        while self._queued:
            if not self._try_start(self._queued[0]):
                break
            self._queued.popleft()
        self.ck.pump()
        ready: List[ServeRequest] = []
        still: List[ServeRequest] = []
        for req in self._ingesting:
            fut = req._view_fut
            if not fut.done:
                still.append(req)
                continue
            try:
                msg = fut.value()
            except BaseException as e:  # terminal (recovery already ran/off)
                req.status = "failed"
                req.error = e
                self.metrics.record_failed()
                self.failed.append(req)
                self.release(req)
                continue
            req.prompt = np.frombuffer(msg.data, dtype=self.meta.dtype)
            req.status = "ready"
            req.t_ingested = time.perf_counter()
            self.metrics.record_ingested(req.t_ingested - req.arrival_t)
            ready.append(req)
        self._ingesting = still
        self._closing = [c for c in self._closing if not self._reap_close(c)]
        # walk the backpressure state back down as the queue drains
        if self._queued:
            self.metrics.set_state(
                "shedding" if len(self._queued) >= self.max_pending
                else "queueing")
        else:
            self.metrics.set_state("open")
        return ready

    def _reap_close(self, entry: Tuple[CkFuture, int]) -> bool:
        fut, nbytes = entry
        if not fut.done:
            return False
        try:
            fut.value()
        except BaseException:
            pass                     # close errors already surfaced elsewhere
        self._inflight_bytes -= nbytes
        return True

    # -- hand-off --------------------------------------------------------------
    def release(self, req: ServeRequest) -> None:
        """Drop the request's borrowed view and close its session (async;
        the arena returns to the pool un-quarantined because no export
        outlives this call). Idempotent."""
        req.prompt = None            # the only live export of the view
        req._view_fut = None
        sess, req._session = req._session, None
        if sess is None:
            return
        f: CkFuture = CkFuture()
        self.ck.close_read_session(sess, f)
        self._closing.append((f, req._nbytes))

    # -- draining --------------------------------------------------------------
    def inflight(self) -> int:
        """Requests admitted but not yet handed off (queued + ingesting)."""
        return len(self._queued) + len(self._ingesting)

    def drain_closes(self, timeout: float = 30.0) -> None:
        """Pump until every async session close has retired (shutdown path:
        nothing may be left holding a pooled arena)."""
        deadline = time.perf_counter() + timeout
        while self._closing and time.perf_counter() < deadline:
            self.ck.pump()
            self._closing = [
                c for c in self._closing if not self._reap_close(c)]
