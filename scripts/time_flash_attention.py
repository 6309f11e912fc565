#!/usr/bin/env python3
"""Time the port's flash-attention kernel from one source tree, on one card.

    python3 scripts/time_flash_attention.py [--src DIR] [--build DIR]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its ``flash_attention.cu`` into ``--build`` and prints one JSON line:
the card's name, and the kernel's mean device time in ms (CUDA events
behind a spin kernel, as ``chip_smoke.py`` times) at phi4-mini's served
decode shape (B=1, H=24, K=8, hd=128, Sk=144) and 2048-token causal
prefill, bf16. Two trees are compared on one card by running the script
for each in turn (parent, change, change, parent) in one session.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"decode": (1, 144), "prefill": (2048, 2048)}   # key -> (Sq, Sk)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--build", default=os.path.join(ROOT, "build",
                                                    "time_flash_attention"))
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = args.build
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import torch

    from repro_torch.kernels import flash_attention as FA

    from chip_smoke import time_ms      # after repro_torch: it adds ./src

    if not torch.cuda.is_available():
        print("time_flash_attention: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {"src": os.path.relpath(os.path.abspath(args.src), ROOT),
           "card": card}
    for key, (sq, sk) in CASES.items():
        q = torch.randn((1, 24, sq, 128), device="cuda", generator=g,
                        dtype=torch.bfloat16)
        k = torch.randn((1, 8, sk, 128), device="cuda", generator=g,
                        dtype=torch.bfloat16)
        v = torch.randn((1, 8, sk, 128), device="cuda", generator=g,
                        dtype=torch.bfloat16)
        out[f"{key}_ms"] = time_ms(lambda: FA.flash_attention_cuda(q, k, v),
                                   200 if sq == 1 else 20)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
