"""Serving subsystem: continuous-batching decode over per-request CkIO
sessions.

This package is the repo's "millions of users" scenario — the opposite
regime from the training pipeline's few long-lived sessions: thousands of
short-lived prompt-ingest sessions per second (on the thread backend, or
on the pooled workers and recycled arenas of a shared reader service,
``ipc/service.py``), driving a continuous-batching decode loop with tail-latency accounting.

The contracts, briefly (full versions in each module's docstring):

**Session lifetime per request** (``ingest.py``): one CkIO read session per
request, open only from admission until the decode engine has consumed the
prompt — ``submit -> [queued] -> ingesting -> ready -> admitted`` (session
closes here) ``-> decoding -> done``.

**View lifetime vs slot eviction** (``ingest.py`` / ``engine.py``): the
prompt is delivered as a borrowed zero-copy view of the session arena and
is consumed *during* ``engine.admit``; ``RequestIngester.release`` then
drops every export and closes the session before decode continues. Slot
eviction (EOS/max-tokens) therefore never touches CkIO state, and no view
outlives its session — the service's arena segments recycle instead of
quarantining.

**When ``ServeOverloaded`` surfaces vs queues** (``ingest.py``): a
``ServiceBusy`` from the reader tier or a tripped inflight-ingest-byte
budget *queues* the request (bounded FIFO, retried every poll — admitted,
never dropped); only a submit that finds that queue already full is
rejected with :class:`~repro_torch.serve.ingest.ServeOverloaded`. The decode loop
itself never blocks on a saturated reader tier.

Batching policies live in ``batching.py`` (continuous vs static over the
same engine, plus the legacy model-level ``BatchServer``); decode engines
in ``engine.py`` (a modeled-cost engine for churn benchmarks, a real
per-slot model engine whose decode attention runs the flash-attention
kernel on the card, and the sequential oracle both are bit-identical to); metrics in :class:`~repro_torch.core.metrics.ServeMetrics` on the Director
observer path.
"""

from repro_torch.serve.serve_step import greedy_generate, make_decode_step
from repro_torch.serve.batching import (
    BatchServer,
    ContinuousBatcher,
    Request,
    StaticBatcher,
)
from repro_torch.serve.engine import (
    ModeledEngine,
    ModelEngine,
    decode_one,
    sequential_oracle,
)
from repro_torch.serve.ingest import (
    RequestIngester,
    ServeOverloaded,
    ServeRequest,
    ServiceBusy,
)

__all__ = [
    "greedy_generate",
    "make_decode_step",
    "BatchServer",
    "Request",
    "ContinuousBatcher",
    "StaticBatcher",
    "ModeledEngine",
    "ModelEngine",
    "decode_one",
    "sequential_oracle",
    "RequestIngester",
    "ServeOverloaded",
    "ServeRequest",
    "ServiceBusy",
]
