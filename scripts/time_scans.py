#!/usr/bin/env python3
"""Time the port's two scan kernels from one source tree, on one card.

    python3 scripts/time_scans.py [--src DIR] [--build DIR] [--label NAME]
                                  [--entries all|forward|backward]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its scan sources (``mamba_scan.cu``, ``mamba_scan_bwd.cu`` where the
tree has it, ``rglru_scan.cu``) into ``--build`` and
prints one JSON line: the card's name and power limit, and the mean device
time in ms (CUDA events behind a spin kernel, as ``chip_smoke.py`` times)
of each entry the tree has, at the shapes ``chip_smoke.py`` times:

* ``mamba_scan`` (literal, fp32): falcon-mamba decode (B=1, S=1, D=8192,
  N=16, h0 and h_S) and B=8, S=2048;
* ``mamba_scan_fused`` (bf16, proj rows of 288 values, z a view of the
  (B, S, 2D) product): the same two shapes, with xin contiguous and with
  xin channel-major (the conv's layout);
* ``rglru_scan`` (literal, fp32): recurrentgemma decode (B=1, S=1,
  W=2560, h0) and B=8, S=2048;
* ``rglru_scan_gated`` (bf16): the same two shapes, xr channel-major and
  contiguous;
* the three backward entries at a microbatch of the train cell (B=2,
  S=2048), as ``chip_smoke.py``'s ``train_ssm`` and ``train_hybrid`` hold
  them: ``mamba_scan_backward`` (fp32, D=8192, N=16),
  ``mamba_scan_fused_backward`` (bf16, xin channel-major, z a view, proj
  rows of 288) and ``rglru_scan_gated_backward`` (bf16, W=2560, xr
  channel-major, gate a view), each beside the device time of its own
  kernels alone (``chip_smoke.kernels_alone_ms``, key ``.../kernels``)
  and by kernel (``.../by_kernel``).

Inputs are made on the card from seed 0. A tree without the fused entries
times the literal ones only. Two trees are compared on one card by running
the script for each in turn (parent, change, change, parent) in one run
of the machine.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--build", default=os.path.join(ROOT, "build",
                                                    "time_scans"))
    ap.add_argument("--label", default="")
    ap.add_argument("--entries", choices=("all", "forward", "backward"),
                    default="all")
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = args.build
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import torch

    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import rglru_scan as LRU

    from chip_smoke import kernels_alone_ms, time_ms  # adds ./src

    if not torch.cuda.is_available():
        print("time_scans: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rnd = lambda *s: torch.randn(s, device=dev, generator=g)  # noqa: E731
    bf16 = torch.bfloat16
    out = {"card": card, "src": args.src, "label": args.label}

    def timed(key, fn, s):
        it, warm = (200, 5) if s == 1 else (20, 2)
        out[key] = time_ms(fn, it, warm)

    def kernels_alone(key, fn):
        out[f"{key}/kernels"], out[f"{key}/by_kernel"] = kernels_alone_ms(fn)

    shapes = (("decode", 1, 1), ("bound", 8, 2048))
    for key, b, s in (shapes if args.entries != "backward" else ()):
        d, n = 8192, 16
        with_h0 = s == 1
        h0 = rnd(b, d, n) * 0.5 if with_h0 else None
        A, Bx = rnd(b, s, d, n).sigmoid_(), rnd(b, s, d, n).mul_(0.1)
        C = rnd(b, s, n)
        timed(f"mamba_scan/{key}", lambda: MS.mamba_scan_cuda(
            A, Bx, C, h0=h0, return_state=with_h0), s)
        del A, Bx, C
        torch.cuda.empty_cache()
        if hasattr(MS, "mamba_scan_fused_cuda"):
            A_log = torch.log(torch.arange(1, n + 1, device=dev,
                                           dtype=torch.float32)).repeat(d, 1)
            rest = (rnd(b, s, d).mul_(0.5).to(bf16),
                    rnd(d).mul_(0.1).add_(math.log(math.expm1(1e-2))), A_log,
                    rnd(b, s, 256 + 2 * n).to(bf16), torch.ones(d, device=dev),
                    rnd(b, s, 2 * d).to(bf16)[..., d:])
            for layout, xin in (("", rnd(b, s, d).to(bf16)),
                                ("/xin_channel_major",
                                 rnd(b, d, s).to(bf16).transpose(1, 2))):
                timed(f"mamba_scan_fused/{key}{layout}",
                      lambda: MS.mamba_scan_fused_cuda(
                          xin, *rest, h0=h0, return_state=with_h0), s)
        w = 2560
        h0 = rnd(b, w) * 0.5 if with_h0 else None
        a, x = rnd(b, s, w).sigmoid_(), rnd(b, s, w).mul_(0.1)
        timed(f"rglru_scan/{key}", lambda: LRU.rglru_scan_cuda(a, x, h0=h0), s)
        if hasattr(LRU, "rglru_scan_gated_cuda"):
            lam = torch.log(torch.expm1(-torch.log(torch.linspace(
                0.9, 0.999, w, device=dev)) / 8.0))
            pre = (rnd(b, s, w), rnd(b, s, w), rnd(w) * 0.1, rnd(w) * 0.1, lam)
            gate = rnd(b, s, w).to(bf16)
            for layout, xr in (("", rnd(b, w, s).to(bf16).transpose(1, 2)),
                               ("/xr_contiguous", rnd(b, s, w).to(bf16))):
                timed(f"rglru_scan_gated/{key}{layout}",
                      lambda: LRU.rglru_scan_gated_cuda(
                          *pre, xr, gate, h0=h0, return_state=with_h0), s)
        torch.cuda.empty_cache()
    if args.entries != "forward":
        backward(torch, dev, rnd, out, timed, kernels_alone)
    print(json.dumps(out), flush=True)
    return 0


def backward(torch, dev, rnd, out, timed, kernels_alone) -> None:
    """The three backward entries at a microbatch of the train cell."""
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import rglru_scan as LRU

    b, s, d, n, w = 2, 2048, 8192, 16, 2560
    bf16 = torch.bfloat16
    A, Bx = rnd(b, s, d, n).sigmoid_(), rnd(b, s, d, n).mul_(0.1)
    C, gy = rnd(b, s, n), rnd(b, s, d)
    fn = lambda: MS.mamba_scan_backward_cuda(gy, A, Bx, C)  # noqa: E731
    timed("mamba_scan_backward/train", fn, s)
    kernels_alone("mamba_scan_backward/train", fn)
    del A, Bx, C, gy
    torch.cuda.empty_cache()
    A_log = torch.log(torch.arange(1, n + 1, device=dev,
                                   dtype=torch.float32)).repeat(d, 1)
    fargs = (F.silu(rnd(b, d, s)).transpose(1, 2).to(bf16),
             rnd(b, s, d).mul_(0.5).to(bf16),
             rnd(d).mul_(0.1).add_(math.log(math.expm1(1e-2))), A_log,
             rnd(b, s, 256 + 2 * n).to(bf16), rnd(d).mul_(0.1).add_(1.0),
             rnd(b, s, 2 * d).to(bf16)[..., d:])
    gy = rnd(b, s, d).to(bf16)
    fn = lambda: MS.mamba_scan_fused_backward_cuda(gy, *fargs)  # noqa: E731
    timed("mamba_scan_fused_backward/train", fn, s)
    kernels_alone("mamba_scan_fused_backward/train", fn)
    del fargs, gy
    torch.cuda.empty_cache()
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, device=dev)) / 8.0))
    largs = (rnd(b, s, w), rnd(b, s, w), rnd(w) * 0.1, rnd(w) * 0.1, lam,
             rnd(b, w, s).to(bf16).transpose(1, 2),
             F.gelu(rnd(b, s, 2 * w), approximate="tanh").to(bf16)[..., w:])
    gy = rnd(b, s, w).to(bf16)
    fn = lambda: LRU.rglru_scan_gated_backward_cuda(gy, *largs)  # noqa: E731
    timed("rglru_scan_gated_backward/train", fn, s)
    kernels_alone("rglru_scan_gated_backward/train", fn)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
