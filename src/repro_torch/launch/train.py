"""End-to-end training driver: CkIO input pipeline + microbatched train loop.

Synthetic corpus -> CkIO read sessions -> double-buffered batches (host
path, or device ingest with on-device reassembly) -> microbatched AdamW
step on one device. The flags are the reference driver's plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Flags for parts
that this port does not carry yet raise; see ROADMAP.md, Queue A.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 6 \
      --global-batch 8 --seq 128 --streaming

The step loop is plain: an exception propagates. Checkpoints and the
restart supervisor come with the next slice. A stack with a recurrent
layer (``--arch falcon-mamba-7b``, ``recurrentgemma-2b``) trains on the
CPU only: its scan kernels are forward-only, so on the card the driver
raises before it builds anything.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import MAMBA, RGLRU
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core import CkIO, FileOptions
from repro_torch.data import CkIOPipeline, make_token_file
from repro_torch.device import resolve_device
from repro_torch.kernels import mamba_scan, rglru_scan
from repro_torch.models import build_model
from repro_torch.train import OptConfig, init_opt_state, make_train_step

# flag -> (value that means "not set", slice that brings it)
_LATER = {
    "resume": (False, "supervisor and checkpoint"),
    "ckpt_dir": (None, "supervisor and checkpoint"),
    "ckpt_every": (None, "supervisor and checkpoint"),
    "compression": (None, "compression"),
    "topology": (None, "NUMA"),
    "numa_pin": (False, "NUMA"),
    "service": (False, "process backend and service"),
    "adaptive_splinters": (False, "direct I/O and async submit"),
    "tuned_env": (False, "benchmark legs"),
    "direct_io": (False, "direct I/O and async submit"),
    "readahead_mb": (0, "direct I/O and async submit"),
    "submit_mode": ("auto", "direct I/O and async submit"),
    "adaptive_queue": (False, "direct I/O and async submit"),
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
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
                    help="token file path (written if missing); more than one"
                         " path (a FileSet) is not carried yet")
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
    ap.add_argument("--placement", default="node_spread",
                    choices=["round_robin", "node_spread", "domain_spread",
                             "near_consumers"])
    ap.add_argument("--backend", default="thread",
                    choices=["thread", "process"])
    ap.add_argument("--max-workers", type=int, default=4)
    ap.add_argument("--pool-workers", type=int, default=4)
    ap.add_argument("--queue-depth", type=int, default=0)
    # Flags of the reference driver whose parts come with later slices.
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", default=None, choices=[None, "bf16"])
    ap.add_argument("--topology", default=None)
    ap.add_argument("--numa-pin", action="store_true")
    ap.add_argument("--service", action="store_true")
    ap.add_argument("--adaptive-splinters", action="store_true")
    ap.add_argument("--tuned-env", action="store_true")
    ap.add_argument("--direct-io", action="store_true")
    ap.add_argument("--readahead-mb", type=int, default=0)
    ap.add_argument("--submit-mode", default="auto",
                    choices=["auto", "io_uring", "threads"])
    ap.add_argument("--adaptive-queue", action="store_true")
    return ap


def _reject_unported(args) -> None:
    for name, (unset, slice_name) in _LATER.items():
        if getattr(args, name) != unset:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} is not carried by the port yet: "
                f"it comes with the {slice_name} slice (ROADMAP.md, Queue A)")
    if len(args.data) > 1:
        raise NotImplementedError("a multi-shard --data corpus (FileSet) comes "
                                  "with the FileSet slice (ROADMAP.md, Queue A)")


def main(argv: Optional[List[str]] = None) -> Dict:
    args = _parser().parse_args(argv)
    _reject_unported(args)
    if args.streaming:
        args.device_ingest = True
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if torch.device(args.device).type == "cuda":
        for mixer, kernel in ((MAMBA, mamba_scan), (RGLRU, rglru_scan)):
            if any(s.mixer == mixer for s in cfg.block_pattern):
                raise NotImplementedError(kernel.FORWARD_ONLY)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params≈{cfg.param_counts()['total']/1e6:.1f}M device={dev}")

    # -- corpus + CkIO pipeline ------------------------------------------------
    path = args.data[0]
    if not os.path.exists(path):
        need = args.steps * args.global_batch * (args.seq + 1) + 1024
        print(f"writing synthetic corpus: {path} ({need} tokens)")
        make_token_file(path, need, cfg.vocab_size, seed=0)
    num_pes = 4
    ckio = CkIO(num_pes=num_pes, pes_per_node=num_pes)
    pipe = CkIOPipeline(
        path, args.global_batch, args.seq,
        ckio=ckio, num_consumers=args.num_consumers,
        file_opts=FileOptions(num_readers=args.num_readers,
                              placement=args.placement,
                              backend=args.backend,
                              queue_depth=args.queue_depth),
        streaming=args.streaming,
        device=dev,
    )

    # -- state -----------------------------------------------------------------
    params = model.init(0, device=dev)
    opt = init_opt_state(params)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        decay_steps=args.steps)
    train_step = make_train_step(model, opt_cfg,
                                 num_microbatches=args.microbatches)

    def batch_for(step: int):
        if args.device_ingest:
            # One host→device transfer of the whole window (one per splinter
            # when streaming); batch-major reassembly on the device.
            x, y = pipe.get_batch_device(step % pipe.num_steps)
        else:
            x, y = pipe.to_device(*pipe.get_batch(step % pipe.num_steps))
        return {"tokens": x, "labels": y}

    log = []
    t0 = time.time()
    try:
        for step in range(1, args.steps + 1):
            params, opt, m = train_step(params, opt, batch_for(step - 1))
            loss = float(m["loss"])
            log.append({"step": step, "loss": loss})
            if step % 10 == 0 or step == args.steps:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({(time.time()-t0)/step:.2f}s/step)")
    finally:
        pipe.close()
    summary = {
        "final_loss": log[-1]["loss"] if log else None,
        "first_loss": log[0]["loss"] if log else None,
        "steps": len(log),
        "device": str(dev),
        "ingest": pipe.ingest.summary(),
        "stream": pipe.stream.summary() if args.streaming else None,
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
