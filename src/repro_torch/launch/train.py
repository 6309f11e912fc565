"""End-to-end training driver: CkIO input pipeline + supervised train loop.

Synthetic corpus -> CkIO read sessions -> double-buffered batches (host
path, or device ingest with on-device reassembly) -> microbatched AdamW
step on one device -> async packed checkpoints -> restart supervisor. The
flags are the reference driver's plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path) and ``--layers`` (the config's width
at a cut depth). ``--tuned-env`` re-executes the driver through
``scripts/env.sh`` (allocator preload, quiet logs) once, as the
reference's does.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 6 \
      --global-batch 8 --seq 128 --streaming --ckpt-every 2

More than one ``--data`` path reads the list as one ``FileSet`` (each shard
written if missing), and ``--direct-io``, ``--queue-depth N``,
``--readahead-mb M``, ``--submit-mode``, ``--adaptive-queue`` and
``--adaptive-splinters`` set the cold-path read engine (``io/submit.py``,
``core/autotune.py``); the summary's ``read`` and ``shards`` blocks report
what the sessions ran with and read, and its ``fetch`` block how long a
requested window waited to start and where each batch fetch spent its time
(``fetch_summary``).

``--backend process --max-workers N`` reads every step window through
reader worker processes that fill a shared-memory arena (``ipc/``), and
``--topology {auto,<int>}`` / ``--numa-pin`` / ``--placement
domain_spread|near_consumers`` place readers and their stripes' pages by
NUMA domain (``core/placement.py``, ``io/numa.py``); the summary's
``locality`` block counts same- and cross-domain bytes, pinned threads and
first-touched pages. Batches are the thread backend's, bit for bit.

``--service --pool-workers N`` (implies ``--backend process``) runs every
step session on a persistent reader service (``ipc/service.py``): N
long-lived workers re-armed per session through shared-memory mailboxes,
and arenas recycled from a pool, instead of worker interpreters started
and a fresh segment created each step. The pool starts once, before the
first session; the summary's ``service`` block holds its
``ServiceMetrics`` (checkouts, arena hits, rearms, evictions).

Checkpoints hold the train state in the reference's layout
(``models.convert.train_state_to_reference``, stacked on the host), so
either package resumes from the other's; ``--resume`` continues from the
latest one in ``--ckpt-dir``. A restore writes the file's values into the
live state in place (``make_supervisor``). A stack with a recurrent layer
(``--arch falcon-mamba-7b``, ``recurrentgemma-2b``) trains on the card
like any other: each scan's gradient comes from its backward kernel (the
reference's from XLA's autodiff). ``--arch qwen2-vl-2b`` trains on tokens, as the
reference's driver does (M-RoPE over broadcast positions); the
encoder-decoder ``whisper-medium`` is refused, since its loss needs encoder
frames that a token corpus does not hold (the reference's driver fails
there on a missing ``batch["embeds"]``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core import CkIO, FileOptions, Topology
from repro_torch.core.metrics import SessionMetrics
from repro_torch.data import CkIOPipeline, FileSet, make_token_file
from repro_torch.device import resolve_device
from repro_torch.ipc.service import ReaderService, ServiceOptions
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_reference, train_state_to_reference
from repro_torch.train import (
    AsyncCheckpointer,
    OptConfig,
    StepSupervisor,
    init_opt_state,
    make_train_step,
    restore_tree,
)

def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (its"
                         " width is kept)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--num-readers", type=int, default=4)
    ap.add_argument("--num-consumers", type=int, default=16)
    ap.add_argument("--data", nargs="+",
                    default=[os.path.join(tempfile.gettempdir(),
                                          "repro_torch_train_tokens.bin")],
                    help="token file path(s), each written if missing; more"
                         " than one path opens the list as a FileSet — one"
                         " logical row space over all shards"
                         " (data/fileset.py), read through one shard-aware"
                         " session per step window")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the device-ingest"
                         " path; 'cpu' runs the plain PyTorch versions")
    ap.add_argument("--device-ingest", action="store_true",
                    help="one transfer of the whole step window + on-device"
                         " batch reassembly (kernels/ops.py) instead of"
                         " host-side batch construction")
    ap.add_argument("--streaming", action="store_true",
                    help="stage each splinter host->device as its read"
                         " completes and reassemble from the chunk list on"
                         " device (implies --device-ingest)")
    ap.add_argument("--topology", default=None,
                    help="NUMA topology for the reader runtime: 'auto'"
                         " detects the host's NUMA nodes from sysfs (with"
                         " CPU sets for --numa-pin); an integer subdivides"
                         " each logical node into that many memory domains."
                         " Enables domain-coalesced pieces, cross-domain"
                         " delivery accounting, and first-touch arena"
                         " striping (each reader faults its own stripe's"
                         " pages on its own domain)")
    ap.add_argument("--numa-pin", action="store_true",
                    help="pin each reader thread or worker process to the"
                         " host CPUs of its stripe's NUMA domain (requires"
                         " --topology; best-effort — outcomes are counted"
                         " in the locality summary)")
    ap.add_argument("--placement", default="node_spread",
                    choices=["round_robin", "node_spread", "domain_spread",
                             "near_consumers"],
                    help="reader->PE placement policy (core/placement.py);"
                         " near_consumers/domain_spread use --topology"
                         " when given")
    ap.add_argument("--backend", default="thread",
                    choices=["thread", "process"],
                    help="reader backend: 'thread' (helper I/O threads in"
                         " this process) or 'process' (reader worker"
                         " processes preadv-ing into a shared-memory arena,"
                         " splinter events over cross-process rings —"
                         " repro_torch/ipc); every ingest mode works"
                         " unchanged")
    ap.add_argument("--max-workers", type=int, default=4,
                    help="process backend: cap on reader worker processes"
                         " per session")
    ap.add_argument("--service", action="store_true",
                    help="run every step session on a persistent reader"
                         " service (ipc/service.py): pooled long-lived"
                         " workers re-armed per session through shm"
                         " mailboxes and recycled arenas, instead of"
                         " starting worker processes and creating a fresh"
                         " segment each step. Implies --backend process")
    ap.add_argument("--pool-workers", type=int, default=4,
                    help="--service: persistent workers in the pool"
                         " (sessions check workers out per step; sizing it"
                         " at --max-workers keeps a step fully parallel)")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="in-flight splinter reads per reader: 0/1 = the"
                         " blocking loop, >= 2 = depth-managed async"
                         " submission (io_uring when available, else a"
                         " preadv pool)")
    ap.add_argument("--direct-io", action="store_true",
                    help="open the corpus O_DIRECT: reads bypass the page"
                         " cache and DMA into the session arena; a shard"
                         " off the block grid raises DirectIOError, never a"
                         " silent buffered read")
    ap.add_argument("--readahead-mb", type=int, default=0,
                    help="WILLNEED window (MB) advised ahead of the async"
                         " submission frontier (buffered files only)")
    ap.add_argument("--submit-mode", default="auto",
                    choices=["auto", "io_uring", "threads"],
                    help="async submission backend selection")
    ap.add_argument("--adaptive-queue", action="store_true",
                    help="let the Director's QueueTuner pick (queue-depth,"
                         " readahead) per session from observed throughput;"
                         " the explicit flags then only seed the first"
                         " session")
    ap.add_argument("--adaptive-splinters", action="store_true",
                    help="size splinters per session from observed"
                         " per-reader throughput and steal pressure"
                         " (core/autotune.py SplinterSizer)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpts"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--compression", default=None, choices=[None, "bf16"],
                    help="round the grads through bf16 before the optimizer"
                         " (what a bf16 DP all-reduce would carry)")
    ap.add_argument("--tuned-env", action="store_true",
                    help="re-exec once through scripts/env.sh (allocator"
                         " preload and the runtime knobs it exports) before"
                         " anything else runs")
    return ap


def _reexec_tuned(argv: List[str]) -> None:
    """Re-exec ``python -m repro_torch.launch.train argv`` through
    ``scripts/env.sh`` so that ``LD_PRELOAD`` and the rest exist before the
    interpreter starts. ``env.sh`` exports ``CKIO_TUNED_ENV=1``, which
    breaks the loop; this package's source root is put on ``PYTHONPATH`` so
    that ``-m`` finds it. Returns (after a note on stderr) where the script
    is missing."""
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env_sh = os.path.join(os.path.dirname(src), "scripts", "env.sh")
    if not os.path.exists(env_sh):
        print(f"--tuned-env: {env_sh} not found; continuing untuned",
              file=sys.stderr)
        return
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv]
    refs = " ".join(['"$0"'] + [f'"${{{i}}}"' for i in range(1, len(cmd))])
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)
    os.execvpe("bash", ["bash", "-c", f'source "{env_sh}" && exec {refs}',
                        *cmd], env)


def read_summary(sessions: List[SessionMetrics]) -> Dict:
    """The read sessions' submission shape and observables, summed (bytes,
    direct tails) or as their range over the run (depth, readahead, the
    in-flight high-water mark), from the ``SessionMetrics`` the Director's
    observer path saw."""
    def span(vals):
        return [min(vals), max(vals)] if vals else None

    return {
        "sessions": len(sessions),
        "bytes_read": sum(m.bytes_read for m in sessions),
        "submit_backend": sorted({m.submit_backend or "blocking"
                                  for m in sessions}),
        "direct_io": sorted({m.direct_io for m in sessions}),
        "queue_depth": span([m.queue_depth for m in sessions]),
        "readahead_bytes": span([m.readahead_bytes for m in sessions]),
        "inflight_hwm": span([m.inflight_hwm for m in sessions]),
        "workers": span([m.workers for m in sessions]),
        "worker_attach_ms": span([m.worker_attach_s * 1e3
                                  for m in sessions if m.workers]),
        "worker_boot_ms": span([m.worker_boot_s * 1e3
                                for m in sessions if m.worker_boot_s]),
        "worker_import_ms": span([m.worker_import_s * 1e3
                                  for m in sessions if m.worker_import_s]),
        "pooled_sessions": sum(m.pooled for m in sessions),
        "service_checkout_ms": span([m.service_checkout_s * 1e3
                                     for m in sessions if m.pooled]),
        "degraded_sessions": sum(m.recovery.degraded_mode
                                 for m in sessions),
        "direct_tail_reads": sum(m.recovery.direct_tail_reads
                                 for m in sessions),
        "direct_tail_bytes": sum(m.recovery.direct_tail_bytes
                                 for m in sessions),
    }


def fetch_summary(sessions: List[SessionMetrics]) -> Dict:
    """The input path's phases over the step sessions a fetch consumed
    (``data/pipeline.py``, "The input path's own trace"), in ms, mean and
    max: how long a requested window waited for its session to start, and
    each fetch split into waiting for reader threads, CkIO's task code run
    on the training thread, and the stage after the wait; and the
    scheduler tasks a fetch ran, mean."""
    fetched = [m for m in sessions if m.fetch_s]

    def ms(vals):
        if not vals:
            return None
        return {"mean": sum(vals) / len(vals) * 1e3, "max": max(vals) * 1e3}

    return {
        "sessions": len(fetched),
        "session_queue_ms": ms([m.t_start - m.t_requested for m in fetched
                                if m.t_requested and m.t_start]),
        "fetch_io_wait_ms": ms([m.fetch_parked_s for m in fetched]),
        "fetch_tasks_ms": ms([m.fetch_pump_s - m.fetch_parked_s
                              for m in fetched]),
        "fetch_stage_ms": ms([m.fetch_s - m.fetch_pump_s for m in fetched]),
        "fetch_tasks": (sum(m.fetch_tasks for m in fetched) / len(fetched)
                        if fetched else None),
    }


def make_supervisor(step_fn, cfg: ModelConfig, ckpt_dir: str, *,
                    ckpt_every: int, keep: int = 3) -> StepSupervisor:
    """``step_fn`` (``(state, batch) -> (state, metrics)`` on a
    ``{"params", "opt"}`` state) under the restart supervisor: async
    checkpoints of the state in the reference's layout, stacked on the host,
    every ``ckpt_every`` steps in ``ckpt_dir`` (the newest ``keep`` kept),
    and restores written into the live state in place."""
    return StepSupervisor(
        step_fn, AsyncCheckpointer(ckpt_dir, keep=keep), ckpt_every=ckpt_every,
        to_tree=lambda st: train_state_to_reference(st, cfg),
        from_tree=lambda tree, st: train_state_from_reference(tree, cfg,
                                                              into=st))


def resume(sup: StepSupervisor, state):
    """``(state, step)`` from the newest checkpoint of ``sup``, or
    ``(state, 0)`` when there is none."""
    path = sup.ckpt.latest()
    if path is None:
        return state, 0
    tree, step = restore_tree(path)
    return sup.from_tree(tree, state), step


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.tuned_env and not os.environ.get("CKIO_TUNED_ENV"):
        _reexec_tuned(argv)
    if args.numa_pin and not args.topology:
        ap.error("--numa-pin requires --topology (the topology supplies "
                 "the domain->CPU map; without it nothing would be pinned)")
    if args.service:
        args.backend = "process"
    if args.streaming:
        args.device_ingest = True
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if cfg.is_encdec:
        raise SystemExit(
            f"training example targets decoder-only archs: {cfg.name}'s loss "
            f"needs encoder frames (batch['embeds']), which a token corpus "
            f"does not hold")
    dev = resolve_device(args.device)
    model = build_model(cfg)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params≈{cfg.param_counts()['total']/1e6:.1f}M device={dev}")

    # -- corpus + CkIO pipeline ------------------------------------------------
    need = args.steps * args.global_batch * (args.seq + 1) + 1024
    per_shard = (need + len(args.data) - 1) // len(args.data)
    for i, p in enumerate(args.data):
        if not os.path.exists(p):
            print(f"writing synthetic corpus shard: {p} ({per_shard} tokens)")
            make_token_file(p, per_shard, cfg.vocab_size, seed=i)
    if len(args.data) > 1:
        # One FileSet manifest = one logical row space; shard starts become
        # hard stripe bounds inside each session plan.
        data_source = FileSet.build(args.data)
        print(f"fileset: {data_source.describe()}")
    else:
        data_source = args.data[0]
    # One host: a single scheduler node of num_pes PEs, so the NUMA
    # topology's node grid matches the scheduler's (a mismatched grid is
    # rejected by place_readers at session start).
    num_pes = 4
    ckio = CkIO(num_pes=num_pes, pes_per_node=num_pes)
    topology = (Topology.from_spec(args.topology, num_pes=num_pes,
                                   pes_per_node=num_pes)
                if args.topology else None)
    sessions: List[SessionMetrics] = []
    ckio.director.add_observer(sessions.append)
    service = None
    if args.service:
        service = ReaderService(ServiceOptions(
            pool_workers=args.pool_workers))
        print(f"reader service: pool of {args.pool_workers} persistent "
              f"workers (steady-state sessions re-arm, not respawn)")
    try:
        summary = _train(args, cfg, model, dev, data_source, ckio, topology,
                         sessions, service)
    finally:
        if service is not None:
            service.shutdown()
    print(json.dumps(summary, indent=2))
    return summary


def _train(args, cfg: ModelConfig, model, dev, data_source, ckio: CkIO,
           topology, sessions: List[SessionMetrics], service) -> Dict:
    """The pipeline, the state and the supervised loop of :func:`main`;
    returns the run's summary. The caller owns (and shuts down) the
    reader ``service``."""
    pipe = CkIOPipeline(
        data_source, args.global_batch, args.seq,
        ckio=ckio, num_consumers=args.num_consumers,
        file_opts=FileOptions(num_readers=args.num_readers,
                              adaptive_splinters=args.adaptive_splinters,
                              placement=args.placement,
                              topology=topology,
                              numa_pin=args.numa_pin,
                              prefault_arena=(topology is not None
                                              or args.backend == "process"),
                              backend=args.backend,
                              max_workers=args.max_workers,
                              direct_io=args.direct_io,
                              queue_depth=args.queue_depth,
                              readahead_bytes=args.readahead_mb * (1 << 20),
                              submit_mode=args.submit_mode,
                              adaptive_queue=args.adaptive_queue),
        service=service,
        streaming=args.streaming,
        device=dev,
    )

    # -- state -----------------------------------------------------------------
    params = model.init(0, device=dev)
    opt = init_opt_state(params)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        decay_steps=args.steps)
    train_step = make_train_step(model, opt_cfg,
                                 num_microbatches=args.microbatches,
                                 compression=args.compression)

    def step_fn(state, batch):
        p, o, metrics = train_step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, metrics

    def batch_for(step: int):
        if args.device_ingest:
            # One host→device transfer of the whole window (one per splinter
            # when streaming); batch-major reassembly on the device.
            x, y = pipe.get_batch_device(step % pipe.num_steps)
        else:
            x, y = pipe.to_device(*pipe.get_batch(step % pipe.num_steps))
        return {"tokens": x, "labels": y}

    sup = make_supervisor(step_fn, cfg, args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    ck = sup.ckpt
    state = {"params": params, "opt": opt}
    start = 0
    log = []
    t0 = time.time()

    def on_metrics(step, m):
        loss = float(m["loss"])
        log.append({"step": step, "loss": loss})
        if step % 10 == 0 or step == args.steps:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({(time.time()-t0)/max(step-start,1):.2f}s/step)")

    try:
        if args.resume and ck.latest():
            state, start = resume(sup, state)
            print(f"resumed from step {start}")
        state = sup.run(state, batch_for, args.steps, start_step=start,
                        on_metrics=on_metrics)
    finally:
        ck.shutdown()
        pipe.close()
    summary = {
        "final_loss": log[-1]["loss"] if log else None,
        "first_loss": log[0]["loss"] if log else None,
        "steps": sup.stats.steps_run,
        "failures": sup.stats.failures,
        "device": str(dev),
        "ingest": pipe.ingest.summary(),
        "stream": pipe.stream.summary() if args.streaming else None,
        "read": read_summary(sessions),
        "fetch": fetch_summary(sessions),
        "locality": (ckio.director.locality.summary()
                     if topology is not None else None),
        "shards": (ckio.director.shards.summary()
                   | {"shard_bytes": dict(ckio.director.shards.shard_bytes)}
                   if len(args.data) > 1 else None),
        "service": (service.metrics.summary() if service is not None
                    else None),
    }
    return summary


if __name__ == "__main__":
    main()
