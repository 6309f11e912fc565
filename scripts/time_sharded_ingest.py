#!/usr/bin/env python3
"""Time ``CkIOPipeline.get_batch_device`` with and without a constructor
sharding, whole-window and streamed, in turns on one device.

    python3 scripts/time_sharded_ingest.py [--device cuda|cpu] [--steps N]
                                           [--gap-ms MS]

Writes a corpus of ``--steps`` windows of the train step's shape (B=8,
S=2048, uint32 ids from seed 0) under ``build/``, opens a world-size-1
process group (nccl on a card, gloo if nccl refuses or on the CPU) and a
``("data",)`` ``DeviceMesh``, then runs four pipelines a mode in turns:
unsharded, sharded, sharded, unsharded (``NamedSharding(mesh, P("data",
None))``). A step is ``pipe.idle(gap)`` (the scheduler pumped while the
next windows read, as a train step's compute lets it), then
``get_batch_device`` between two synchronizations, timed on the host
clock: the time a trainer waits for its batch. The first step of each
pipeline (the first session and, once, the CUDA context) is left out.
Prints one JSON line: the device's name (and, on a card, its power
limit), and per mode and variant the median, quartiles and mean in ms of
the steps of both turns, and the batches' equality across variants.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
B, S = 8, 2048


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(path, dev, streaming, sharding, steps, gap_s):
    """Per-step ``get_batch_device`` ms (host clock, synchronized) and the
    local batches."""
    from repro_torch.core import CkIO, FileOptions
    from repro_torch.data import CkIOPipeline

    pipe = CkIOPipeline(
        path, B, S, ckio=CkIO(num_pes=4, pes_per_node=4), num_consumers=16,
        file_opts=FileOptions(num_readers=4), streaming=streaming,
        sharding=sharding, device=dev)
    ms, batches = [], []
    try:
        for step in range(steps):
            pipe.idle(gap_s)
            _sync(dev)
            t0 = time.perf_counter()
            x, y = pipe.get_batch_device(step)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if sharding is not None:
                x, y = x.to_local(), y.to_local()
            batches.append((x.cpu(), y.cpu()))
    finally:
        pipe.close()
    return ms[1:], batches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--gap-ms", type=float, default=50.0)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data import make_token_file
    from repro_torch.device import resolve_device
    from repro_torch.launch.sharding import NamedSharding, P

    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    if dev.type == "cuda":
        name = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="time_sharded_", dir=os.path.join(ROOT,
                                                                    "build"))
    try:
        path = os.path.join(tmp, "corpus.bin")
        make_token_file(path, args.steps * B * (S + 1), 200064, seed=0)
        backend = "gloo"
        if dev.type == "cuda":
            try:
                dist.init_process_group("nccl", store=dist.HashStore(),
                                        rank=0, world_size=1)
                backend = "nccl"
            except Exception:   # noqa: BLE001  (gloo below; the line says)
                pass
        if not dist.is_initialized():
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
        try:
            mesh = DeviceMesh(dev.type, torch.arange(1),
                              mesh_dim_names=("data",))
            sh = NamedSharding(mesh, P("data", None))
            out = {"device": name, "backend": backend, "steps": args.steps,
                   "gap_ms": args.gap_ms}
            for mode in ("window", "streamed"):
                times = {"unsharded": [], "sharded": []}
                got = {}
                for variant in ("unsharded", "sharded", "sharded",
                                "unsharded"):
                    ms, batches = _run(
                        path, dev, mode == "streamed",
                        sh if variant == "sharded" else None, args.steps,
                        args.gap_ms / 1e3)
                    times[variant] += ms
                    got.setdefault(variant, batches)
                equal = all(torch.equal(a, b) for (xa, ya), (xb, yb) in
                            zip(got["unsharded"], got["sharded"])
                            for a, b in ((xa, xb), (ya, yb)))
                out[mode] = {"batches_equal": equal}
                for variant, ms in times.items():
                    q = np.percentile(ms, [25, 50, 75])
                    out[mode][variant] = {
                        "n": len(ms), "median_ms": float(q[1]),
                        "q1_ms": float(q[0]), "q3_ms": float(q[2]),
                        "mean_ms": statistics.fmean(ms)}
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
