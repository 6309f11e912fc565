#!/usr/bin/env python3
"""Time the port's flash-attention kernel from one source tree, on one card.

    python3 scripts/time_flash_attention.py [--src DIR] [--build DIR]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its ``flash_attention.cu`` into ``--build`` and prints one JSON line:
the card's name and power limit, and for each case the kernel's mean device
time in ms (CUDA events behind a spin kernel, as ``chip_smoke.py`` times)
and that of ``scaled_dot_product_attention(enable_gqa=True)`` on the same
inputs. The cases are the shapes ``chip_smoke.py`` times, B=1, bf16:
phi4-mini's served decode (H=24, K=8, hd=128, Sk=144) and 2048-token
causal prefill; recurrentgemma's decode (H=10, K=1, hd=256) at Sk 1, 17,
129, 144 and a full 2,048-slot ring, and its 2048-token prefill with
window 2048; and the ring in fp32, as the ring-wrap replay runs it. Two
trees are compared on one card by running the script for each in turn
(parent, change, change, parent) in one session.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# key -> (H, K, hd, Sq, Sk, window, dtype); the keys of chip_smoke.py's
# flash_attention timings, and the fp32 ring.
CASES = {
    "decode": (24, 8, 128, 1, 144, 0, "bfloat16"),
    "prefill": (24, 8, 128, 2048, 2048, 0, "bfloat16"),
    "decode_hd256_sk1": (10, 1, 256, 1, 1, 0, "bfloat16"),
    "decode_hd256_sk17": (10, 1, 256, 1, 17, 0, "bfloat16"),
    "decode_hd256_sk129": (10, 1, 256, 1, 129, 0, "bfloat16"),
    "decode_hd256": (10, 1, 256, 1, 144, 0, "bfloat16"),
    "decode_hd256_ring": (10, 1, 256, 1, 2048, 0, "bfloat16"),
    "prefill_hd256": (10, 1, 256, 2048, 2048, 2048, "bfloat16"),
    "decode_hd256_ring_fp32": (10, 1, 256, 1, 2048, 0, "float32"),
}


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
    import torch.nn.functional as F

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
    for key, (h, kv, hd, sq, sk, window, dtype) in CASES.items():
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((1, n, s, hd), device="cuda", generator=g,
                               dtype=dt)
                   for n, s in ((h, sq), (kv, sk), (kv, sk)))
        it = 200 if sq == 1 else 20
        out[f"{key}_ms"] = time_ms(
            lambda: FA.flash_attention_cuda(q, k, v, window=window), it)
        # Sq = 1 keeps every key (no mask); a window as long as the
        # sequence masks nothing more than causal.
        out[f"{key}_sdpa_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=sq > 1, enable_gqa=True), it)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
