"""Serving driver: request serving with CkIO-loaded prompts.

Static mode (default) runs the pad-to-bucket ``BatchServer`` over one bulk
prompt read. Continuous mode (``--continuous``) runs the serving
subsystem: per-request sessions out of a sharded ``FileSet`` on the thread
backend, a ``RequestIngester`` with bounded-queue backpressure, and the
``ContinuousBatcher`` decode loop over a per-slot ``ModelEngine`` — ending
with a ``ServeMetrics`` summary table (arrival→ingested / →first-token /
→e2e p50/p99/p999, occupancy, sessions/sec, backpressure counters).

The flags are the reference driver's plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path) and ``--layers`` (the config's width
at a cut depth, as the train driver's). ``--arch`` takes the families the
port carries: ``phi4-mini-3.8b`` (the default), ``codeqwen1.5-7b``,
``phi3-medium-14b`` and ``gemma3-27b`` (dense attention; gemma3's local
layers over 1,024-slot rings), ``qwen2-moe-a2.7b`` and ``olmoe-1b-7b``
(attention with Mixture-of-Experts FFNs), each decode call through the
flash-attention kernel in every attention layer; ``falcon-mamba-7b``
(attention-free; each decode call through the selective-scan kernel) and
``recurrentgemma-2b`` (the reference's default; each decode call through
the RG-LRU kernel in its 18 recurrent layers and the flash-attention kernel
over a local-window ring in its 8 attention layers). As the reference's
driver, it refuses ``qwen2-vl-2b`` and ``whisper-medium`` ("serving
example targets token-input archs"): they are served through the library
(``BatchServer``, ``greedy_generate(frames=)``, ``ModelEngine(frames=)``
behind a ``ContinuousBatcher``). Params in another
``param_dtype`` than the config's (gemma3-27b's fp32 params exceed one
80 GB card; bf16 ones fit) come in through ``main(argv, params=...)``.
``--continuous --service --pool-workers N`` runs the request sessions on
the process backend through a persistent reader service
(``ipc/service.py``): N pooled workers re-armed per request and recycled
arenas, each session pinned to the pool (``use_service=True``); the
summary's ``pooled_sessions`` counts the requests the pool served.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --requests 12 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --continuous --arrival-rate 50
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --requests 4 --batch 4 --prompt-len 64 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --requests 4 --batch 4 --prompt-len 128 --max-new 16
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core import CkIO, FileOptions, ServeMetrics
from repro_torch.data import FileSet, make_token_file, read_meta, write_token_shards
from repro_torch.device import resolve_device
from repro_torch.ipc.service import ReaderService, ServiceOptions
from repro_torch.models import build_model
from repro_torch.serve import (
    BatchServer,
    ContinuousBatcher,
    ModelEngine,
    Request,
    RequestIngester,
    ServeOverloaded,
    ServeRequest,
)

@dataclass
class ServeRun:
    """What one mode's run leaves for its caller to check."""

    summary: Dict[str, Any]
    requests: List[Any]                 # Request (static) / ServeRequest
    corpus: np.ndarray                  # the prompt tokens, row order
    metrics: Optional[ServeMetrics] = None
    engine: Optional[ModelEngine] = None


def _print_metrics_table(metrics: ServeMetrics) -> None:
    s = metrics.summary()
    print("\nServeMetrics")
    print(f"  {'metric':<26} {'value':>14}")
    for k in sorted(s):
        v = s[k]
        print(f"  {k:<26} {v:>14.6g}")
    if metrics.transitions:
        print("  backpressure transitions:",
              ", ".join(f"{k}×{v}" for k, v in metrics.transitions.items()))


def serve_static(args, model, params, cfg) -> ServeRun:
    # prompts arrive through CkIO (the request file is one large shared file)
    n_tokens = args.requests * args.prompt_len
    make_token_file(args.data, n_tokens, cfg.vocab_size, seed=7)
    meta = read_meta(args.data)
    ck = CkIO(num_pes=2)
    fh = ck.open_sync(args.data, FileOptions(num_readers=2))
    off, nbytes = meta.byte_range_for_rows(0, n_tokens)
    sess = ck.start_read_session_sync(fh, nbytes, off)
    buf = np.empty(n_tokens, dtype=meta.dtype)
    ck.read_sync(sess, nbytes, off, memoryview(buf).cast("B"))
    ck.close_read_session_sync(sess)
    ck.close_sync(fh)
    prompts = buf.reshape(args.requests, args.prompt_len).astype(np.int32)

    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=args.max_new)
            for i in range(args.requests)]
    server = BatchServer(model, params, batch_size=args.batch)
    t0 = time.time()
    done = server.serve(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.result) for r in done)
    lats = sorted(r.latency_s for r in done)
    summary = {
        "mode": "static",
        "requests": len(done),
        "total_s": round(dt, 3),
        "new_tokens": total_new,
        "tok_per_s": round(total_new / dt, 1),
        "latency_p50_s": round(lats[len(lats) // 2], 4),
        "latency_max_s": round(lats[-1], 4),
        "all_completed": all(r.result is not None for r in done),
    }
    print(json.dumps(summary, indent=2))
    return ServeRun(summary, done, prompts.reshape(-1))


def serve_continuous(args, model, params, cfg) -> ServeRun:
    n_tokens = args.requests * args.prompt_len
    # prompt corpus as a sharded FileSet — the production corpus shape
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, size=(n_tokens,),
                          dtype=np.int32)
    shard_dir = args.data + ".shards"
    per = n_tokens // max(1, args.shards)
    counts = [per] * (args.shards - 1) + [n_tokens - per * (args.shards - 1)]
    fs = FileSet.build(write_token_shards(shard_dir, tokens, counts))

    ck = CkIO(num_pes=2)
    metrics = ServeMetrics()
    ck.director.add_observer(metrics.record_session)
    service = None
    if args.service:
        service = ReaderService(ServiceOptions(
            pool_workers=args.pool_workers))
        ck.director.attach_service(service)
    try:
        return _serve_continuous(args, model, params, cfg, rng, tokens, fs,
                                 ck, metrics, service)
    finally:
        if service is not None:
            service.shutdown()


def _serve_continuous(args, model, params, cfg, rng, tokens, fs, ck,
                      metrics, service) -> ServeRun:
    opts = FileOptions(
        num_readers=2,
        backend="process" if service is not None else "thread",
        max_workers=2,
        use_service=True if service is not None else None,
    )
    fh = ck.open_fileset_sync(fs, opts)
    ingester = RequestIngester(
        ck, fh, fs, metrics,
        max_pending=max(8, args.requests),
        max_inflight_bytes=int(args.max_inflight_mb * (1 << 20)),
        service=service,
    )
    engine = ModelEngine(model, params, slots=args.batch,
                         seq_budget=args.prompt_len + args.max_new + 8)
    batcher = ContinuousBatcher(engine, ingester)

    reqs = [ServeRequest(rid=i, row_start=i * args.prompt_len,
                         num_rows=args.prompt_len,
                         max_new_tokens=args.max_new)
            for i in range(args.requests)]
    if args.arrival_rate > 0:
        gaps = rng.exponential(1.0 / args.arrival_rate, size=len(reqs))
        arrivals = np.cumsum(gaps)
    else:
        arrivals = np.zeros(len(reqs))
    shed = []
    state = {"idx": 0, "t0": time.perf_counter()}

    def pump() -> bool:
        now = time.perf_counter() - state["t0"]
        while state["idx"] < len(reqs) and arrivals[state["idx"]] <= now:
            try:
                ingester.submit(reqs[state["idx"]])
            except ServeOverloaded:
                shed.append(reqs[state["idx"]].rid)
            state["idx"] += 1
        return state["idx"] < len(reqs)

    t0 = time.time()
    done = batcher.run(pump)
    dt = time.time() - t0
    ck.close_sync(fh)
    total_new = sum(len(r.result) for r in done)
    summary = {
        "mode": "continuous",
        "requests": len(done),
        "shed": len(shed),
        "total_s": round(dt, 3),
        "new_tokens": total_new,
        "tok_per_s": round(total_new / dt, 1),
        "all_completed": len(done) + len(shed) == args.requests,
        "pooled_sessions": metrics.pooled_sessions,
    }
    print(json.dumps(summary, indent=2))
    _print_metrics_table(metrics)
    return ServeRun(summary, done, tokens, metrics, engine)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (its"
                         " width is kept)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size / continuous decode slots")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--data", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_serve_prompts.bin"))
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model; 'cpu' runs the plain "
                         "PyTorch versions")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over per-request sessions")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = all at once)")
    ap.add_argument("--max-inflight-mb", type=float, default=64.0,
                    help="ingest backpressure budget (open session bytes)")
    ap.add_argument("--shards", type=int, default=3,
                    help="prompt FileSet shard count (continuous mode)")
    ap.add_argument("--service", action="store_true",
                    help="continuous mode: run the request sessions on the"
                         " process backend through a pooled ReaderService")
    ap.add_argument("--pool-workers", type=int, default=2,
                    help="--service: persistent workers in the pool")
    return ap


def main(argv: Optional[List[str]] = None, *, params=None) -> ServeRun:
    """Run one mode. ``params`` (optional) are random weights the caller
    already made for this arch on this device, so one process can serve
    both modes from the same model."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if cfg.is_encdec or cfg.input_mode == "embeddings":
        raise SystemExit("serving example targets token-input archs")
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev)
    if args.continuous:
        return serve_continuous(args, model, params, cfg)
    return serve_static(args, model, params, cfg)


if __name__ == "__main__":
    main()
