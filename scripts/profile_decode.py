#!/usr/bin/env python3
"""Launches, device time and wall time of a served B=1 decode call, from one
source tree, on one card.

    python3 scripts/profile_decode.py [--src DIR] [--build DIR]
        [--arch falcon-mamba-7b --arch recurrentgemma-2b] [--calls 16]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its kernels into ``--build`` and, for each ``--arch`` at full width
with random weights from seed 0 and bf16 compute, replays a prompt through
decode (64 tokens for falcon-mamba-7b, 128 otherwise, as ``chip_smoke.py``
serves them), then runs ``--calls`` greedy B=1 decode calls twice: once on
the host clock with a synchronize after each call (wall time a call), and
once under ``torch.profiler`` (kernels and copies a call, device time a
call as the sum of their device times, busy share). Prints one JSON line
an arch with the card's name and power limit. Two trees are compared on
one card by running the script for each in turn (parent, change, change,
parent) in one run of the machine.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = {"falcon-mamba-7b": 64}   # others: 128


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--build", default=os.path.join(ROOT, "build",
                                                    "profile_decode"))
    ap.add_argument("--arch", action="append")
    ap.add_argument("--calls", type=int, default=16)
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = args.build
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import reassemble as K
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    K.build()
    dev = torch.device("cuda", 0)
    for arch in args.arch or ["falcon-mamba-7b", "recurrentgemma-2b"]:
        prompt_len = PROMPTS.get(arch, 128)
        model = build_model(get_config(arch))
        params = model.init(0, device=dev)
        tok = torch.arange(prompt_len, dtype=torch.int32, device=dev)[None]
        n = args.calls
        with torch.no_grad():
            state = model.init_decode_state(params, 1, prompt_len + 2 * n)
            for t in range(prompt_len):
                logits, state = model.decode(params, state,
                                             {"tokens": tok[:, t:t + 1]})
            torch.cuda.synchronize()

            def call():
                nonlocal logits, state
                nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                logits, state = model.decode(params, state, {"tokens": nxt})

            walls = []
            for _ in range(n):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        rows = [(e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0]
        busy_us = sum(r[0] for r in rows)
        walls.sort()
        print(json.dumps({
            "card": card, "src": args.src, "arch": arch, "calls": n,
            "positions": [prompt_len, prompt_len + 2 * n - 1],
            "wall_ms_mean": sum(walls) / n * 1e3,
            "wall_ms_median": walls[n // 2] * 1e3,
            "kernels_per_call": sum(r[1] for r in rows) / n,
            "device_ms_per_call": busy_us / n / 1e3,
            "profiled_wall_ms_per_call": prof_wall / n * 1e3,
            "busy_share": busy_us / 1e6 / prof_wall}), flush=True)
        del model, params, state, logits, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
