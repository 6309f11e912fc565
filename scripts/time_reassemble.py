#!/usr/bin/env python3
"""Time the port's three reassembly kernels from one source tree, on one card.

    python3 scripts/time_reassemble.py [--src DIR] [--build DIR] [--label NAME]
                                       [--cases SUBSTR]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its ``reassemble.cu`` into ``--build`` and prints one JSON line: the
card's name and power limit and, for each case, the mean device time in ms
(CUDA events behind a spin kernel, as ``chip_smoke.py`` times; a wrapper's
table upload is on the stream, so it is timed), the bytes bound at 3.35
TB/s and, for token maps, the 32-byte-sector floor. Cases, int32 tokens:

* ``window/main_1chunk``, ``window/main_4chunks``: the train step's window
  (B=8, S=2048) whole, and in 4 separately allocated chunks (streamed by
  4 readers);
* ``window/64MiB``, ``window/64MiB_16KiB_chunks``: B=8192 rows of 2049
  tokens, whole and in 16 KiB chunks (4,098 of them);
* ``tokens/main_arrival``: the train window's map when it arrives in 16 KiB
  splinters in a shuffled order;
* ``tokens/64MiB_random``, ``tokens/64MiB_arrival``: B=8192, a random
  permutation and 16 KiB splinters in a shuffled order;
* ``block/main``, ``block/64MiB``: the block gather at the arrival phase's
  shape (2,049 blocks of 8 tokens) and over 8,192 rows of 2,049 tokens.

The 4,098-chunk window spends milliseconds a call on the host (a table
of 4,098 pointers built in Python), so it is timed behind a longer spin,
and its host time a call is printed beside it. ``--cases`` keeps the
cases whose name contains the substring.

Inputs are made from seed 0. Two trees are compared on one card by running
the script for each in turn (parent, change, change, parent) in one run of
the machine.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, BIG_B, SPLINTER = 8, 2048, 8192, 4096      # 16 KiB of int32 tokens


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--build", default=os.path.join(ROOT, "build",
                                                    "time_reassemble"))
    ap.add_argument("--label", default="")
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    os.environ["REPRO_TORCH_BUILD_DIR"] = args.build
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from repro_torch.kernels import reassemble as K

    from chip_smoke import (  # after repro_torch: it adds ./src
        arrival_row_idx,
        bound_ms,
        split_chunks,
        time_ms,
        tokens_sector_floor_bytes,
    )

    if not torch.cuda.is_available():
        print("time_reassemble: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ints = lambda n: torch.from_numpy(  # noqa: E731
        rng.integers(0, 200064, size=n).astype(np.int32)).to(dev)
    out = {"card": card, "src": args.src, "label": args.label}

    def window(key, chunks, b):
        kw = dict(global_batch=b, seq_len=S)
        n = b * (S + 1)
        out[key] = {"ms": None, "chunks": len(chunks),
                    "bound_ms": bound_ms(4 * n + 8 * b * S)}
        return lambda: K.reassemble_window_cuda(chunks, **kw)

    def tokens(key, staged, row_idx):
        b = row_idx.shape[0]
        n_read = int(torch.unique(row_idx[row_idx >= 0]).numel())
        out[key] = {"ms": None,
                    "bound_ms": bound_ms(4 * row_idx.numel() + 4 * n_read
                                         + 8 * b * S),
                    "sector_floor_ms": bound_ms(
                        tokens_sector_floor_bytes(row_idx))}
        return lambda: K.reassemble_tokens_cuda(staged, row_idx)

    def block(key, src, idx):
        row = src[0].numel() * 4
        out[key] = {"ms": None,
                    "bound_ms": bound_ms(2 * idx.numel() * row
                                         + 4 * idx.numel())}
        return lambda: K.reassemble_cuda(src, idx)

    main_lin = ints(B * (S + 1))
    big = ints(BIG_B * (S + 1))
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    make = {
        "window/main_1chunk": lambda k: window(k, [main_lin], B),
        "window/main_4chunks": lambda k: window(
            k, split_chunks(main_lin, -(-main_lin.numel() // 4)), B),
        "window/64MiB": lambda k: window(k, [big], BIG_B),
        "window/64MiB_16KiB_chunks": lambda k: window(
            k, split_chunks(big, SPLINTER), BIG_B),
        "tokens/main_arrival": lambda k: tokens(
            k, main_lin, as_dev(arrival_row_idx(rng, B, S, SPLINTER))),
        "tokens/64MiB_random": lambda k: tokens(
            k, big, as_dev(rng.permutation(big.numel()).astype(np.int32)
                           .reshape(BIG_B, S + 1))),
        "tokens/64MiB_arrival": lambda k: tokens(
            k, big, as_dev(arrival_row_idx(rng, BIG_B, S, SPLINTER))),
        "block/main": lambda k: block(
            k, main_lin.reshape(-1, 8),
            as_dev(rng.permutation(main_lin.numel() // 8).astype(np.int32))),
        "block/64MiB": lambda k: block(
            k, big.reshape(BIG_B, S + 1),
            as_dev(rng.permutation(BIG_B).astype(np.int32))),
    }
    for key, mk in make.items():
        if args.cases not in key:
            continue
        fn = mk(key)
        many = key.endswith("_chunks")
        it = 10 if many else 20 if "64MiB" in key else 200
        K.reset_launch_counts()
        out[key]["ms"] = time_ms(fn, it, 5,
                                 spin_cycles=800_000_000 if many else 50_000_000)
        ups = getattr(K, "TABLE_UPLOADS", None)   # the parent has no count
        out[key]["table_uploads_per_call"] = (None if ups is None
                                              else ups / (it + 5))
        out[key]["share_of_bound"] = out[key]["bound_ms"] / out[key]["ms"]
        if many:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(it):
                fn()
            out[key]["host_ms_per_call"] = (time.perf_counter() - t0) / it * 1e3
            torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
