"""Request batching: continuous batching under churn + the static baseline.

Three servers over two substrates:

  * :class:`ContinuousBatcher` — the serving subsystem's decode loop: each
    tick polls the :class:`~repro_torch.serve.ingest.RequestIngester`, admits
    ready requests into free engine slots, steps every occupied slot one
    token, and evicts on EOS/max-tokens. No batch formation wait, no
    padding waste: a slot frees the moment its request finishes and the
    next request takes it mid-decode.
  * :class:`StaticBatcher` — the honest baseline on the SAME engine and
    ingester: wait for a full batch (or end of stream), decode until every
    member finishes (finished members keep burning their slot — padding
    waste), return all results at batch end (batch-formation + straggler
    wait land in every member's latency).
  * :class:`BatchServer` — the legacy model-level static server
    (pad-to-bucket + ``greedy_generate``), kept as the example's default
    path. Latency is measured from request *arrival* (``Request.arrival_t``),
    split into ``queue_wait_s`` (arrival -> its batch starts) and
    ``service_s`` (the batch's decode time) — not from batch start, which
    silently hid the queueing component.

Both engine-based batchers follow the shared completion rule of
``serve/engine.py`` (``decode_one``), so their outputs are bit-identical to
the sequential oracle regardless of arrival order, slot assignment, or
co-residency.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.metrics import ServeMetrics
from repro_torch.models.model_zoo import Model
from repro_torch.serve.ingest import RequestIngester, ServeRequest
from repro_torch.serve.serve_step import greedy_generate


@dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int = 16
    arrival_t: Optional[float] = None   # perf_counter stamp; None = at serve()
    result: Optional[np.ndarray] = None
    latency_s: float = 0.0         # arrival -> response (queueing + service)
    queue_wait_s: float = 0.0      # arrival -> its batch started decoding
    service_s: float = 0.0         # the batch's own decode time


@dataclass
class BatchServer:
    model: Model
    params: Any
    batch_size: int = 4
    bucket: int = 32               # prompts padded up to a multiple of this
    stats: Dict[str, float] = field(default_factory=dict)

    def serve(self, requests: List[Request]) -> List[Request]:
        # bucket by padded length so every batch is uniform
        by_len: Dict[int, List[Request]] = {}
        for r in requests:
            L = max(self.bucket, (len(r.prompt) + self.bucket - 1)
                    // self.bucket * self.bucket)
            by_len.setdefault(L, []).append(r)
        t_all = time.perf_counter()
        for r in requests:
            if r.arrival_t is None:      # legacy callers: arrival = serve()
                r.arrival_t = t_all
        for L, group in sorted(by_len.items()):
            for i in range(0, len(group), self.batch_size):
                chunk = group[i : i + self.batch_size]
                t0 = time.perf_counter()
                prompts = np.zeros((len(chunk), L), np.int32)
                for j, r in enumerate(chunk):
                    prompts[j, L - len(r.prompt):] = r.prompt  # left-pad
                max_new = max(r.max_new_tokens for r in chunk)
                out = greedy_generate(
                    self.model, self.params,
                    torch.from_numpy(prompts).to(self.model.device(self.params)),
                    max_new,
                )
                out = out.cpu().numpy()
                t_end = time.perf_counter()
                for j, r in enumerate(chunk):
                    r.result = out[j, : r.max_new_tokens]
                    r.queue_wait_s = t0 - r.arrival_t
                    r.service_s = t_end - t0
                    r.latency_s = t_end - r.arrival_t
        self.stats["total_s"] = time.perf_counter() - t_all
        self.stats["requests"] = float(len(requests))
        return requests


def _finished(req: ServeRequest, tok: int) -> bool:
    """The shared completion rule (mirrors ``engine.decode_one``)."""
    return (len(req.result) >= req.max_new_tokens
            or (req.eos_id is not None and tok == req.eos_id))


class ContinuousBatcher:
    """Continuous-batching decode loop (module docstring)."""

    def __init__(
        self,
        engine: Any,
        ingester: RequestIngester,
        metrics: Optional[ServeMetrics] = None,
        *,
        idle_sleep_s: float = 2e-4,
    ):
        self.engine = engine
        self.ingester = ingester
        self.metrics = metrics if metrics is not None else ingester.metrics
        self.metrics.slots = engine.slots
        self.idle_sleep_s = idle_sleep_s
        self._ready: Deque[ServeRequest] = deque()
        self._active: Dict[int, ServeRequest] = {}
        self.completed: List[ServeRequest] = []

    def _admit(self, slot: int, req: ServeRequest) -> None:
        self.engine.admit(slot, req.prompt)
        req.result = []
        req.status = "decoding"
        self._active[slot] = req
        # prompt consumed by the prefill above; drop the borrowed view and
        # hand the session's arena back before decode continues
        self.ingester.release(req)
        self.metrics.record_admission()

    def tick(self) -> bool:
        """One loop iteration: poll ingest, fill free slots, step once,
        evict finished. Returns False when no slot was stepped (idle)."""
        self._ready.extend(self.ingester.poll())
        for slot in range(self.engine.slots):
            if not self._ready:
                break
            if slot not in self._active:
                self._admit(slot, self._ready.popleft())
        if not self._active:
            return False
        toks = self.engine.step()
        self.metrics.record_step(len(toks))
        now = time.perf_counter()
        for slot, tok in toks.items():
            req = self._active[slot]
            if req.t_first_token == 0.0:
                req.t_first_token = now
                self.metrics.record_first_token(now - req.arrival_t)
            req.result.append(int(tok))
            if _finished(req, int(tok)):
                self.engine.evict(slot)
                del self._active[slot]
                req.status = "done"
                req.t_done = now
                self.metrics.record_eviction()
                self.metrics.record_completed(
                    now - req.arrival_t, len(req.result), now)
                self.completed.append(req)
        return True

    def run(
        self,
        pump: Optional[Callable[[], bool]] = None,
        timeout_s: float = 300.0,
    ) -> List[ServeRequest]:
        """Drive ticks until every admitted request completes. ``pump`` is
        the load generator's hook — called once per tick to submit due
        arrivals; it returns True while more arrivals are still to come."""
        deadline = time.perf_counter() + timeout_s
        while True:
            more = bool(pump()) if pump is not None else False
            stepped = self.tick()
            if (not more and not stepped and not self._ready
                    and self.ingester.inflight() == 0):
                break
            if not stepped:
                time.sleep(self.idle_sleep_s)   # waiting on arrivals / I/O
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"continuous serve stalled: {len(self._active)} active, "
                    f"{len(self._ready)} ready, "
                    f"{self.ingester.inflight()} in ingest after "
                    f"{timeout_s}s")
        self.ingester.drain_closes()
        return self.completed


class StaticBatcher:
    """Static-batch baseline over the same engine + ingester (module
    docstring): results return only at batch end, finished members keep
    burning their slot until the batch's straggler finishes."""

    def __init__(
        self,
        engine: Any,
        ingester: RequestIngester,
        metrics: Optional[ServeMetrics] = None,
        *,
        batch_size: Optional[int] = None,
        idle_sleep_s: float = 2e-4,
    ):
        self.engine = engine
        self.ingester = ingester
        self.metrics = metrics if metrics is not None else ingester.metrics
        self.metrics.slots = engine.slots
        self.batch_size = batch_size or engine.slots
        self.idle_sleep_s = idle_sleep_s
        self._ready: Deque[ServeRequest] = deque()
        self.completed: List[ServeRequest] = []

    def _fill(self, pump, deadline) -> bool:
        """Batch formation: block until ``batch_size`` requests are ready
        or the stream ends. Returns False when the stream is exhausted."""
        while True:
            more = bool(pump()) if pump is not None else False
            self._ready.extend(self.ingester.poll())
            if len(self._ready) >= self.batch_size:
                return True
            if not more and self.ingester.inflight() == 0:
                return bool(self._ready)
            time.sleep(self.idle_sleep_s)
            if time.perf_counter() > deadline:
                raise RuntimeError("static batch formation stalled")

    def run(
        self,
        pump: Optional[Callable[[], bool]] = None,
        timeout_s: float = 300.0,
    ) -> List[ServeRequest]:
        deadline = time.perf_counter() + timeout_s
        while self._fill(pump, deadline):
            chunk = [self._ready.popleft()
                     for _ in range(min(self.batch_size, len(self._ready)))]
            batch: Dict[int, ServeRequest] = {}
            for slot, req in enumerate(chunk):
                self.engine.admit(slot, req.prompt)
                req.result = []
                req.status = "decoding"
                self.ingester.release(req)
                self.metrics.record_admission()
                batch[slot] = req
            done: set = set()
            while len(done) < len(batch):
                toks = self.engine.step()
                self.metrics.record_step(len(toks))
                now = time.perf_counter()
                for slot, tok in toks.items():
                    if slot in done:
                        continue      # padding waste: slot burns to batch end
                    req = batch[slot]
                    if req.t_first_token == 0.0:
                        req.t_first_token = now
                        self.metrics.record_first_token(
                            now - req.arrival_t)
                    req.result.append(int(tok))
                    if _finished(req, int(tok)):
                        done.add(slot)
                if time.perf_counter() > deadline:
                    raise RuntimeError("static batch decode stalled")
            now = time.perf_counter()
            for slot, req in batch.items():
                self.engine.evict(slot)
                req.status = "done"
                req.t_done = now      # static: results return at batch end
                self.metrics.record_eviction()
                self.metrics.record_completed(
                    now - req.arrival_t, len(req.result), now)
                self.completed.append(req)
        self.ingester.drain_closes()
        return self.completed
