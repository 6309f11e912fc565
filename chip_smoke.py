#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (each failure is reported; any failure exits 1 and prints no result):

1. card      the card's name and power limit, as nvidia-smi reports them;
2. build     nvcc builds every ``kernels/csrc/*.cu`` into ``build/`` (one
             nvcc per source, all started together);
3. kernels   every reassembly kernel against its plain PyTorch version on the
             card, bit-equal, over aligned/unaligned window offsets,
             remainder windows, 1- and many-chunk tables, tables of 127,
             128 and 129 chunks (the by-value cap and one past it, which
             must upload its table), chunk edges inside a 4-token group and
             inside a warp's span, chunk bases off 16 bytes, every row
             misalignment, S not a multiple of 4, B = 1; block gathers in
             f32/bf16/int32 (2-D and 3-D, with repeats); token gathers over
             random maps and maps of splinter runs, with pads in column 0,
             column S and at warp and tile edges, and indices that clip;
4. window    the main path, whole-window device ingest: a uint32 synthetic
             corpus -> ``CkIOPipeline(streaming=False).get_batch_device`` ->
             the microbatched AdamW step of phi4-mini-3.8b at full width
             (d_model 3072, 24/8 heads, head_dim 128, d_ff 8192, vocab
             200,064, tied embeddings) with 4 of its 32 layers, random
             weights from a seed; global batch 8, seq 2048, 4 microbatches,
             4 steps;
5. streamed  the same with ``streaming=True``; batches must be bit-equal to
             phase 4's. In both, the window kernel launches once a step and
             its wrapper uploads no chunk table (the tables go by value);
6. arrival   ``ops.device_ingest`` over arrival-ordered stagings of the
             corpus's step windows, as a CkIO session delivered them (block
             permutation and token-map layouts): the entry point that reaches
             the block and token gather kernels;
7. timing    each kernel, its plain version and, where one exists, a single
             PyTorch call for the same function, at the main-path shapes and
             at a 64 MiB window (whole, and in 4,098 chunks of 16 KiB; token
             maps random and arrival-ordered), beside the bytes bound (3.35
             TB/s) and, for token maps, the 32-byte-sector floor;
8. attention the flash-attention kernel against its plain version on the
             card (fp32 at 1e-5, bf16 at 2e-2): the six sweep cases of
             tests/test_kernels.py, phi4-mini decode shapes (Sq=1, H=24,
             K=8, hd=128, Sk in 1/17/129/2048) and a 2048-token causal
             prefill, recurrentgemma's (Sq=1, H=10, K=1, hd=256, Sk in
             1/17/129/2048, the last a full ring with no window) and a
             2048-token causal prefill with window 2048; then its time, the
             plain version's and ``scaled_dot_product_attention``'s at the
             served decode shapes and at the prefill shapes, beside the
             bound;
9. scan      the literal selective-scan kernel against its plain version
             on the card (1e-4): the four sweep cases of
             tests/test_kernels.py, the falcon-mamba decode shape (B=1, S=1,
             D=8192, N=16) from a random h0 (y and h_S), a 64-token prefill
             and the bound's shape (B=8, S=2048, D=8192, N=16: 2^31
             elements an input); then the fused entry (discretization, scan
             and epilogue) against its plain version (y at 1e-4 in fp32 and
             2e-2 in bf16, h_S at 1e-4): the sweep shapes with odd proj
             rows and a strided z, decode from h0 in bf16 and fp32, a
             64-token prefill and B=8, S=2048. Each is timed beside its
             plain version (and the fused entry beside the composition it
             replaces) and its bound, bytes or special-function units (no
             PyTorch call computes a selective scan);
10. lru      the same for the RG-LRU: the literal kernel (1e-5) over the
             three sweep cases, a ragged case (B=3, S=37, W=50),
             recurrentgemma's decode shape (B=1, S=1, W=2560) from a random
             h0, a 2100-token prefill and the bound's shape (B=8, S=2048,
             W=2560); then the gated entry (gates, recurrence and output
             product; y at 1e-5 in fp32 and 2e-2 in bf16, h_S at 1e-5) at
             the sweep and ragged shapes, decode from h0 in bf16 and fp32,
             the 2100-token prefill and B=8, S=2048, with xr channel-major
             as the conv leaves it (no PyTorch call computes the
             recurrence);
11. serve    the second main path, ``repro_torch.launch.serve``: phi4-mini
             at full width with all 32 layers, random weights from seed 0,
             bf16 compute; static mode (BatchServer over one CkIO bulk read,
             4 requests, batch 4) and continuous mode (a 3-shard FileSet,
             3 requests, 4 slots, Poisson arrivals), 128 prompt tokens and
             16 new tokens a request. Every decode call runs the attention
             of each of the 32 layers through the kernel; continuous tokens
             must equal the sequential oracle's on the same engine, and
             replaying a prompt through decode must give the logits of the
             plain prefill forward;
12. serve_ssm the third main path: the same for falcon-mamba-7b at full
             width with all 64 layers (static: 4 requests, batch 4;
             continuous: 2 requests, 4 slots), 64 prompt tokens and 16 new
             ones a request. Every decode call runs each of the 64 layers'
             discretization, scan and epilogue through the fused kernel
             (S=1 from the carried state), one launch a layer; the prefill
             forward (ssm_impl "materialized") runs the literal kernel once
             a layer over the prompt;
13. serve_hybrid the fourth main path: the same for recurrentgemma-2b at
             full width with all 26 layers (static: 4 requests, batch 4;
             continuous: 3 requests, 4 slots), 128 prompt tokens and 16 new
             ones a request. Every decode call runs the gates, recurrence and
             output product of each of the 18 recurrent layers through the
             gated kernel (S=1 from the carried state), one launch a layer,
             and the attention of each of the 8
             local-attention layers through the flash-attention kernel.
             Then a ring-wrap check: the first 6 layers in fp32, one
             2100-token prompt replayed through decode (the 2048-slot rings
             wrap) against the plain prefill forward (1e-4);
14. profile  only with ``--profile``: two whole-window main-path steps, 16
             B=1 decode calls of phi4-mini and 8 each of falcon-mamba and
             recurrentgemma under ``torch.profiler`` (device busy share,
             kernels and copies a call, kernels by device time).

The launch counts are zeroed just before each main-path run (phases 4-6,
each mode of phases 11-13, the prefill forwards of phase 12's replay check,
and the ring-wrap replay) and read just after it. The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_PEAK = 989e12                 # dense bf16 FLOP/s, same source
FP32_PEAK = 67e12                  # fp32 FLOP/s outside the tensor cores
MUFU_PER_SM_CLOCK = 16             # special-function results an SM a clock
SOURCES = {
    "reassemble_window": "src/repro_torch/kernels/csrc/reassemble.cu",
    "reassemble": "src/repro_torch/kernels/csrc/reassemble.cu",
    "reassemble_tokens": "src/repro_torch/kernels/csrc/reassemble.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "mamba_scan": "src/repro_torch/kernels/csrc/mamba_scan.cu",
    "rglru_scan": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "mamba_scan_fused": "src/repro_torch/kernels/csrc/mamba_scan.cu",
    "rglru_scan_gated": "src/repro_torch/kernels/csrc/rglru_scan.cu",
}
REPLACES = {
    "reassemble_window": "src/repro/kernels/reassemble.py:81",
    "reassemble": "src/repro/kernels/reassemble.py:52",
    "reassemble_tokens": "src/repro/kernels/reassemble.py:173",
    "flash_attention": "src/repro/kernels/flash_attention.py:90",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:44",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:38",
    "mamba_scan_fused": "src/repro/kernels/mamba_scan.py:44",
    "rglru_scan_gated": "src/repro/kernels/rglru_scan.py:38",
}
# What the two fused entries take in beside the Pallas function.
FUSES = {
    "mamba_scan_fused": "the discretization of src/repro/models/ssm.py:95 "
                        "(_fused_chunk_scan) and the skip and gate of "
                        "ssm.py:180-181",
    "rglru_scan_gated": "the gates of src/repro/models/rglru.py:52 (_gates) "
                        "and the output product of rglru.py:90",
}
ARCH_LAYERS = 4
B, S, MICROBATCHES, STEPS = 8, 2048, 4, 4
# Serving: prompt and new tokens per request, requests per mode, slots.
PROMPT, NEW, STATIC_REQUESTS, CONT_REQUESTS, SLOTS = 128, 16, 4, 3, 4
ARRIVAL_RATE = 1.0                 # Poisson arrivals, requests/s
H, KV, HD = 24, 8, 128             # phi4-mini attention heads
# falcon-mamba serving: prompt tokens, requests per mode; d_inner, state.
SSM_PROMPT, SSM_STATIC_REQUESTS, SSM_CONT_REQUESTS = 64, 4, 2
SSM_D, SSM_N = 8192, 16
# recurrentgemma: MQA attention heads; lru_width; local window; the
# ring-wrap check's depth (two blocks: 4 RG-LRU and 2 local layers) and
# prompt (past the 2048-slot rings).
RG_H, RG_KV, RG_HD = 10, 1, 256
RG_REC, RG_LOC = 18, 8             # RG-LRU and local-attention layers
RG_W, RG_WINDOW, WRAP_LAYERS, WRAP_PROMPT = 2560, 2048, 6, 2100
# Logits of a prompt replayed through decode (kernel attention) against the
# plain prefill forward: relative L2 bound by compute dtype. In bf16 each
# path is ~2e-2 from the fp32 logits after 32 layers (a CPU run of
# d_model 768 put both, and their difference, at 1.9e-2), so the bound is
# 5e-2; in fp32 the two differ by summation order only.
PREFILL_REL_TOL = {"bfloat16": 5e-2, "float32": 1e-4}


def log(*a) -> None:
    print(*a, flush=True)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def alternate(fns: dict, it: int, pit: int, warm: int,
              spin_cycles: int = 50_000_000) -> dict:
    """Mean device time of each callable, timed in turns (each of
    ``fns``, then the same in reverse) and averaged; ``kernel`` runs
    ``it`` times a turn, the others ``pit``."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(time_ms(fns[k], it if k == "kernel" else pit, warm,
                              spin_cycles))
    return {k: sum(v) / len(v) for k, v in got.items()}


def time_ms(fn, iters: int = 50, warmup: int = 5,
            spin_cycles: int = 50_000_000) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, from
    CUDA events around the whole run. A spin kernel queued first (~25 ms at
    the default ``spin_cycles``) lets the host enqueue the calls ahead of
    the device, so that a call's host cost (Python, ctypes, allocation) is
    not timed as device time, as long as all ``iters`` calls are enqueued
    within the spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(spin_cycles)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def split_chunks(lin, chunk_tokens: int) -> list:
    """``lin`` cut every ``chunk_tokens`` tokens into separate allocations,
    as a window's splinters arrive when it is streamed."""
    return [c.clone() for c in lin.split(chunk_tokens)]


def skewed_chunks(lin, cuts) -> list:
    """``lin`` cut at ``cuts`` into separate allocations, the odd ones
    views one token into their buffer, so that their base is off a
    16-byte boundary."""
    import torch

    out = []
    for i, c in enumerate(torch.tensor_split(lin, cuts)):
        buf = torch.empty(c.numel() + i % 2, dtype=c.dtype, device=c.device)
        buf[i % 2:] = c
        out.append(buf[i % 2:])
    return out


def arrival_row_idx(rng, b: int, s: int, splinter_tokens: int):
    """The token map (``(b, s+1)`` int32) of a window of ``b`` rows of
    ``s+1`` tokens staged in ``splinter_tokens`` pieces in a shuffled
    arrival order, from ``data.packing.token_gather_from_pieces`` and
    ``row_gather_index``: runs of contiguous staged positions."""
    import numpy as np

    from repro_torch.data.packing import row_gather_index, token_gather_from_pieces

    n = b * (s + 1)
    pieces = [(4 * o, 4 * min(splinter_tokens, n - o))
              for o in range(0, n, splinter_tokens)]
    pieces = [pieces[i] for i in rng.permutation(len(pieces))]
    g = token_gather_from_pieces(pieces, 0, 4)
    return np.ascontiguousarray(row_gather_index(g, global_batch=b, seq_len=s))


def tokens_sector_floor_bytes(row_idx) -> int:
    """Bytes a token gather moves when each gathered 4-byte token costs a
    32-byte sector (a random map): the index rows, one sector per gathered
    (row, column) entry, the two outputs. A floor for a random map, not
    the bound (which counts each distinct token once)."""
    b, s1 = row_idx.shape
    return 4 * row_idx.numel() + 32 * int((row_idx >= 0).sum()) + 8 * b * (s1 - 1)


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.failed = []
        # Kernel against plain version, by kernel; "sdpa" holds the check
        # of the library yardstick against the plain version, apart.
        self.err = {"reassemble_window": 0, "reassemble": 0,
                    "reassemble_tokens": 0, "flash_attention": 0, "sdpa": 0,
                    "mamba_scan": 0, "rglru_scan": 0,
                    "mamba_scan_fused": 0, "rglru_scan_gated": 0}
        self.launches = {}
        self.main_inputs = {}      # kernel -> args captured from the main path
        self.timing = {}
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
        self.batches = {}

    def phase(self, name, fn):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:           # recorded: the run exits 1 at the end
            traceback.print_exc()
            self.failed.append(name)
            log(f"== phase {name} FAILED")
            return
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")

    # -- 1, 2 ------------------------------------------------------------------
    def card(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        self.card_line = out.stdout.strip().splitlines()[0]
        log(self.card_line)
        t = self.torch
        # The special-function units' peak: results an SM a clock at the
        # card's highest SM clock, on every SM.
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        self.sm_count = t.cuda.get_device_properties(0).multi_processor_count
        self.sm_clock_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
        log(f"{self.sm_count} SMs, max SM clock {self.sm_clock_hz / 1e6:.0f} "
            f"MHz: {MUFU_PER_SM_CLOCK * self.sm_count * self.sm_clock_hz:.4e}"
            f" special-function results/s")
        log(f"torch {t.__version__} cuda {t.version.cuda} device "
            f"{t.cuda.get_device_name(0)} count {t.cuda.device_count()}")

    def build(self):
        from repro_torch.kernels import reassemble as K

        t0 = time.perf_counter()
        libs = K.build(verbose=True)
        log(f"built {[os.path.relpath(p, ROOT) for p in libs]} in "
            f"{time.perf_counter() - t0:.1f} s")

    # -- 3 ---------------------------------------------------------------------
    def _same(self, name, got, want) -> None:
        t = self.torch
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                     f"{w.shape}/{w.dtype}")
            diff = (g.float() - w.float()).abs().max().item() if g.numel() else 0.0
            self.err[name] = max(self.err[name], diff)
            if not t.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from the plain "
                                     f"version (max abs err {diff})")

    def kernels(self):
        import numpy as np
        import torch

        from repro_torch.kernels import reassemble as K
        from repro_torch.kernels import ref

        rng = np.random.default_rng(0)
        dev = self.dev
        n = 0
        # window: offsets, remainders, pads, chunk tables of odd sizes
        for case in range(60):
            b = int(rng.integers(1, 9))
            s = int(rng.choice([1, 3, 4, 7, 64, 1000, 1023, 1024, 1025, 2048,
                                2051]))
            s1 = s + 1
            w0 = int(rng.integers(0, 3 * s1)) if case % 3 else 0
            full = w0 + b * s1
            L = int(rng.integers(max(1, full - 2 * s1), full + 9))
            valid = (int(rng.integers(w0, full + 1)) if case % 4 == 1
                     else None)
            lin = torch.from_numpy(
                rng.integers(-2**31, 2**31 - 1, size=L, dtype=np.int64)
                .astype(np.int32)).to(dev)
            nchunks = 1 if case % 2 == 0 else int(rng.integers(2, 12))
            cuts = np.sort(rng.choice(np.arange(1, L), size=min(nchunks - 1,
                                      L - 1), replace=False)) if L > 1 else []
            bounds = [0, *[int(c) for c in cuts], L]
            # Chunks are separate allocations, as streamed splinters are.
            chunks = [lin[bounds[i]:bounds[i + 1]].clone()
                      for i in range(len(bounds) - 1)]
            kw = dict(global_batch=b, seq_len=s, window_tok_off=w0,
                      valid_limit=valid, pad_id=int(rng.integers(0, 7)))
            self._same("reassemble_window",
                       K.reassemble_window_cuda(chunks, **kw),
                       ref.window_chunks_ref(chunks, **kw))
            n += 1
        # block gather: dtypes, 2-D / 3-D, repeats, odd row sizes
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            for shape in ((6, 4), (17, 1000), (33, 3, 5), (9, 4097), (5, 2, 8193)):
                nb = shape[0]
                src = torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32) * 1000).to(dev).to(dt)
                idx = torch.from_numpy(rng.integers(0, nb, size=nb + 3)
                                       .astype(np.int32)).to(dev)
                self._same("reassemble", K.reassemble_cuda(src, idx),
                           ref.reassemble_ref(src, idx))
                n += 1
        # window edges: tables at the by-value cap (one over it takes the
        # device table), chunk edges inside a 4-token group and inside a
        # warp's span with skewed chunk bases, every row misalignment h,
        # S not a multiple of 4, B = 1, remainders and pads
        for extra in (-1, 0, 1):
            nch = K.max_param_chunks() + extra
            b, s, w0 = 3, 509, 5
            L = w0 + b * (s + 1) + 2
            lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L)
                                   .astype(np.int32)).to(dev)
            cuts = np.sort(rng.choice(np.arange(1, L), size=nch - 1,
                                      replace=False)).tolist()
            K.reset_launch_counts()
            kw = dict(global_batch=b, seq_len=s, window_tok_off=w0, pad_id=4)
            chunks = skewed_chunks(lin, cuts)
            self._same("reassemble_window",
                       K.reassemble_window_cuda(chunks, **kw),
                       ref.window_chunks_ref(chunks, **kw))
            if K.TABLE_UPLOADS != (1 if extra > 0 else 0):
                raise AssertionError(f"{nch} chunks: {K.TABLE_UPLOADS} "
                                     f"table uploads")
            n += 1
        for h in range(4):
            for s, b in ((2048, 5), (2051, 3), (127, 1)):
                w0 = 8 + h
                L = w0 + b * (s + 1) - s // 2
                lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L)
                                       .astype(np.int32)).to(dev)
                for step in (37, 130, L):
                    chunks = skewed_chunks(lin, list(range(step, L, step)))
                    for valid in (None, w0 + (s + 1) + 3):
                        kw = dict(global_batch=b, seq_len=s, window_tok_off=w0,
                                  valid_limit=valid, pad_id=9)
                        self._same("reassemble_window",
                                   K.reassemble_window_cuda(chunks, **kw),
                                   ref.window_chunks_ref(chunks, **kw))
                        n += 1
        # token gather: -1 pads, indices past the buffer clip
        for case in range(12):
            b = int(rng.integers(1, 9))
            s = int(rng.choice([2, 5, 64, 2048]))
            L = int(rng.integers(1, 4 * b * (s + 1)))
            staged = torch.from_numpy(rng.integers(0, 200064, size=L)
                                      .astype(np.int32)).to(dev)
            row_idx = torch.from_numpy(rng.integers(-1, L + 5, size=(b, s + 1))
                                       .astype(np.int32)).to(dev)
            self._same("reassemble_tokens",
                       K.reassemble_tokens_cuda(staged, row_idx, pad_id=3),
                       ref.tokens_gather_ref(staged, row_idx, pad_id=3))
            n += 1
        # token maps of splinter runs and random ones, pads in column 0,
        # column S and at warp (128-column) and tile (1024-column) edges,
        # indices past L, S not a multiple of 4, B = 1
        for b, s in ((1, 1), (1, 6), (3, 128), (4, 129), (8, 2048),
                     (2, 2051)):
            L = b * (s + 1) + 11
            staged = torch.from_numpy(rng.integers(0, 200064, size=L)
                                      .astype(np.int32)).to(dev)
            for runs in (True, False):
                row_idx = (arrival_row_idx(rng, b, s, 37) if runs else
                           rng.integers(0, L, size=(b, s + 1)).astype(np.int32))
                for col in (0, 127, 128, 1023, 1024, 1025, s):
                    if col <= s:
                        row_idx[:, col] = -1
                row_idx[:, 1::7] += L
                row_idx = torch.from_numpy(row_idx).to(dev)
                self._same("reassemble_tokens",
                           K.reassemble_tokens_cuda(staged, row_idx, pad_id=3),
                           ref.tokens_gather_ref(staged, row_idx, pad_id=3))
                n += 1
        torch.cuda.synchronize()
        log(f"{n} kernel cases bit-equal to the plain versions; max abs err "
            f"{json.dumps(self.err)}")

    # -- 4, 5 ------------------------------------------------------------------
    def _corpus(self):
        from repro_torch.configs.registry import get_config
        from repro_torch.data import make_token_file

        cfg = get_config("phi4-mini-3.8b")
        path = os.path.join(self.tmp, "corpus.bin")
        if not os.path.exists(path):
            make_token_file(path, STEPS * B * (S + 1) + 1024, cfg.vocab_size,
                            seed=0)
        return cfg, path

    def _trainer(self):
        """The main path's model, state and step: phi4-mini at full width
        with ``ARCH_LAYERS`` layers, random weights from seed 0."""
        from repro_torch.models import build_model
        from repro_torch.train import OptConfig, init_opt_state, make_train_step

        cfg, path = self._corpus()
        cfg = cfg.replace(num_layers=ARCH_LAYERS)
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        step_fn = make_train_step(
            model, OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=STEPS),
            num_microbatches=MICROBATCHES)
        return cfg, path, model, params, init_opt_state(params), step_fn

    def _pipeline(self, path, streaming: bool):
        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data import CkIOPipeline

        return CkIOPipeline(
            path, B, S, ckio=CkIO(num_pes=4, pes_per_node=4),
            num_consumers=16, file_opts=FileOptions(num_readers=4),
            streaming=streaming, device=self.dev)

    def main_path(self, streaming: bool):
        import numpy as np
        import torch

        from repro_torch.kernels import reassemble as K
        from repro_torch.models import build_model

        cfg, path, model, params, opt, step_fn = self._trainer()
        raw = np.fromfile(path, dtype=np.uint32, offset=4096).view(np.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mode = "streamed" if streaming else "window"
        # Capture the window kernel's main-path inputs for phase 7.
        orig = K.reassemble_window_cuda

        def capture(chunks, **kw):
            key = f"reassemble_window/{mode}"
            if key not in self.main_inputs:
                self.main_inputs[key] = ([c.clone() for c in chunks], kw)
            return orig(chunks, **kw)

        pipe = self._pipeline(path, streaming)
        # Time the host→device copy calls (bytes over time inside them).
        to_device = pipe._to_device
        h2d_s = [0.0]

        def timed_to_device(tokens):
            t = time.perf_counter()
            try:
                return to_device(tokens)
            finally:
                h2d_s[0] += time.perf_counter() - t

        pipe._to_device = timed_to_device
        losses, batches, t_steps, t_ingest = [], [], [], []
        K.reset_launch_counts()
        K.reassemble_window_cuda = capture
        try:
            for step in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, y = pipe.get_batch_device(step)
                t_ingest.append(time.perf_counter() - t0)
                params, opt, m = step_fn(params, opt, {"tokens": x, "labels": y})
                losses.append(float(m["loss"]))   # synchronizes
                t_steps.append(time.perf_counter() - t0)
                batches.append((x.cpu().numpy(), y.cpu().numpy()))
        finally:
            K.reassemble_window_cuda = orig
            pipe.close()
        counts = dict(K.LAUNCHES)
        uploads = K.TABLE_UPLOADS
        self.launches[mode] = counts
        peak = torch.cuda.max_memory_allocated()
        ingest = pipe.ingest.summary()
        # The bf16 model against its fp32 self on a small input (2 rows of
        # 256 tokens of the last batch), at the tolerance of the kernel tests.
        small = {"tokens": x[:2, :256], "labels": y[:2, :256]}
        with torch.no_grad():
            lo = model.loss(params, small)[0].item()
            hi = build_model(cfg.replace(dtype="float32")).loss(
                params, small)[0].item()
        del params, opt
        torch.cuda.empty_cache()
        if abs(lo - hi) > 2e-2 * abs(hi):
            raise AssertionError(f"{mode}: bf16 loss {lo} vs fp32 loss {hi}")
        log(f"{mode}: small-input loss bf16 {lo:.6f} fp32 {hi:.6f}")
        # -- checks -------------------------------------------------------------
        need = B * (S + 1)
        for step, (x, y) in enumerate(batches):
            w = raw[step * need:(step + 1) * need].reshape(B, S + 1)
            if not (np.array_equal(x, w[:, :-1]) and np.array_equal(y, w[:, 1:])):
                raise AssertionError(f"{mode} step {step}: batch differs from "
                                     f"the token file")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{mode}: non-finite loss {losses}")
        # Random init with std 0.02 gives near-uniform logits.
        if abs(losses[0] - math.log(cfg.vocab_size)) > 2.0:
            raise AssertionError(f"{mode}: first loss {losses[0]} far from "
                                 f"ln(V) = {math.log(cfg.vocab_size):.3f}")
        if ingest["host_permute_bytes"] != 0:
            raise AssertionError(f"{mode}: host_permute_bytes {ingest}")
        if not streaming and ingest["h2d_transfers"] != STEPS:
            raise AssertionError(f"window: h2d_transfers {ingest} != {STEPS}")
        if counts["reassemble_window"] < STEPS:
            raise AssertionError(f"{mode}: reassemble_window launched "
                                 f"{counts['reassemble_window']} < {STEPS}")
        if uploads != 0:
            raise AssertionError(f"{mode}: the window wrapper uploaded "
                                 f"{uploads} chunk tables (0 expected: the "
                                 f"main path's tables go by value)")
        self.batches[mode] = batches
        steady = t_steps[1:] or t_steps
        step_s = sum(steady) / len(steady)
        ingest_s = sum(t_ingest[1:] or t_ingest) / len(steady)
        # Model FLOPs of a step (no remat recompute): 6 per matmul param and
        # token (the tied embedding counts once, as the unembedding), plus
        # the attention scores and PV products, fwd + bwd, unmasked.
        mat_params = cfg.param_counts()["total"] - 2 * cfg.d_model * cfg.num_layers
        flops = (6 * B * S * mat_params + 12 * cfg.num_layers * B * S * S
                 * cfg.num_heads * cfg.resolved_head_dim)
        log(f"{mode}: losses {losses}")
        log(f"{mode}: model FLOPs/step {flops:.4e} = {flops / step_s / 1e12:.1f}"
            f" TFLOP/s = {flops / step_s / BF16_PEAK:.3f} of the bf16 dense "
            f"peak")
        log(f"{mode}: step time {step_s * 1e3:.1f} ms (mean of steps 2-{STEPS}),"
            f" {B * S / step_s:.0f} tokens/s, first step "
            f"{t_steps[0] * 1e3:.1f} ms; of a step, get_batch_device takes "
            f"{ingest_s * 1e3:.3f} ms (host clock)")
        log(f"{mode}: ingest {json.dumps(ingest)}")
        log(f"{mode}: H2D {ingest['h2d_bytes']:.0f} B in "
            f"{ingest['h2d_transfers']:.0f} copies taking {h2d_s[0] * 1e3:.3f}"
            f" ms = {ingest['h2d_bytes'] / h2d_s[0] / 1e9:.3f} GB/s")
        if streaming:
            log(f"streamed: stream {json.dumps(pipe.stream.summary())}")
        log(f"{mode}: max_memory_allocated {peak / 2**30:.2f} GiB")
        log(f"{mode}: launches {json.dumps(counts)}, chunk-table uploads "
            f"{uploads}")

    def streamed(self):
        self.main_path(streaming=True)
        import numpy as np

        if "window" in self.batches:
            for (xw, yw), (xs, ys) in zip(self.batches["window"],
                                          self.batches["streamed"]):
                if not (np.array_equal(xw, xs) and np.array_equal(yw, ys)):
                    raise AssertionError("streamed batches differ from the "
                                         "whole-window ones")
            log("streamed batches bit-equal to the whole-window batches")

    # -- optional: where a main-path step's device time goes -----------------
    def profile(self):
        """``--profile``: (a) one warm-up step, then two whole-window
        main-path steps under ``torch.profiler``; (b) a PROMPT-token prompt
        replayed through decode on the 32-layer phi4-mini, then ``NEW`` B=1
        bf16 decode calls under the profiler; (c) the same for the 64-layer
        falcon-mamba with SSM_PROMPT tokens and 8 calls, and (d) for the
        26-layer recurrentgemma with PROMPT tokens and 8 calls. Prints the
        device busy share and the kernels by device time of each, and
        writes the full tables to ``profile_window.txt``,
        ``profile_decode.txt``, ``profile_decode_ssm.txt`` and
        ``profile_decode_hybrid.txt``."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        _, path, _, params, opt, step_fn = self._trainer()
        pipe = self._pipeline(path, streaming=False)

        def one(step):
            x, y = pipe.get_batch_device(step)
            nonlocal params, opt
            params, opt, m = step_fn(params, opt, {"tokens": x, "labels": y})
            return float(m["loss"])

        try:
            one(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                for step in (1, 2):
                    one(step)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe.close()
        del params, opt
        torch.cuda.empty_cache()
        self._report_profile(prof, wall, 2, "step", "profile_window.txt")

        self._profile_decode("phi4-mini-3.8b", PROMPT, NEW,
                             "profile_decode.txt")
        self._profile_decode("falcon-mamba-7b", SSM_PROMPT, 8,
                             "profile_decode_ssm.txt")
        self._profile_decode("recurrentgemma-2b", PROMPT, 8,
                             "profile_decode_hybrid.txt")

    def _profile_decode(self, arch, prompt_len, n, fname):
        """A ``prompt_len``-token prompt replayed through decode at full
        width, then ``n`` B=1 bf16 decode calls under the profiler."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.configs.registry import get_config
        from repro_torch.models import build_model

        model = build_model(get_config(arch))
        params = model.init(0, device=self.dev)
        tok = torch.arange(prompt_len, dtype=torch.int32, device=self.dev)[None]
        with torch.no_grad():
            state = model.init_decode_state(params, 1, prompt_len + n)
            for t in range(prompt_len):
                logits, state = model.decode(params, state,
                                             {"tokens": tok[:, t:t + 1]})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                    logits, state = model.decode(params, state,
                                                 {"tokens": nxt})
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del params, state, logits
        torch.cuda.empty_cache()
        log(f"profile: {arch}")
        self._report_profile(prof, wall, n, "decode call", fname)

    def _report_profile(self, prof, wall, n, unit, fname):
        from torch.autograd import DeviceType

        # Device-side events only (kernels, copies), as the profiler's own
        # "Self CUDA time total" counts them; operator rows would count
        # their kernels a second time.
        rows = sorted(
            ((e.self_device_time_total, e.key, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation
             and e.self_device_time_total > 0), reverse=True)
        busy = sum(r[0] for r in rows) / 1e6
        launches = sum(r[2] for r in rows)
        log(f"profile: {n} {unit}s, {wall * 1e3:.1f} ms wall under the "
            f"profiler (host clock), device busy {busy * 1e3:.1f} ms = "
            f"{busy / wall:.3f} of wall; {launches / n:.1f} kernels and "
            f"copies a {unit}")
        for dev_us, key, count in rows[:15]:
            log(f"profile: {dev_us / n / 1e3:9.3f} ms/{unit} {count // n:6d} "
                f"calls/{unit} {dev_us / 1e6 / busy:6.3f} {key[:90]}")
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, fname), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))

    # -- 6 ---------------------------------------------------------------------
    def arrival(self):
        import numpy as np
        import torch

        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data.packing import (
            pieces_in_arrival_order,
            token_gather_from_pieces,
        )
        from repro_torch.data.tokenfile import read_meta
        from repro_torch.kernels import ops
        from repro_torch.kernels import reassemble as K

        _, path = self._corpus()
        meta = read_meta(path)
        raw = np.fromfile(path, dtype=np.uint32, offset=4096).view(np.int32)
        ck = CkIO(num_pes=4, pes_per_node=4)
        # Small splinters, so that each window arrives in many pieces.
        f = ck.open_sync(path, FileOptions(num_readers=4,
                                           splinter_bytes=16 * 1024))
        need = B * (S + 1)
        K.reset_launch_counts()
        try:
            for step in range(2):
                off, nbytes = meta.byte_range_for_rows(step * need, need)
                sess = ck.start_read_session_sync(f, nbytes, off)
                ck.read_view_sync(sess, nbytes, off)     # whole window resident
                order = ck.session_arrival_order(sess)
                pieces = pieces_in_arrival_order(sess.plan.splinters, order)
                g = token_gather_from_pieces(pieces, off, 4)
                # Stage in arrival order (the contiguous layout an
                # arrival-ordered transfer produces); a host concatenation
                # here, since this phase checks the device-side gathers.
                staged_np = np.concatenate(
                    [raw[(o - 4096) // 4:(o - 4096 + nb) // 4] for o, nb in pieces])
                ck.close_read_session_sync(sess)
                staged = torch.from_numpy(staged_np).to(self.dev)
                toks = [nb // 4 for _, nb in pieces] + [(o - off) // 4
                                                        for o, _ in pieces]
                T = math.gcd(*toks)
                want = raw[step * need:(step + 1) * need].reshape(B, S + 1)
                for block_tokens in (T, 0):
                    x, y = ops.device_ingest(staged, g, global_batch=B,
                                             seq_len=S, block_tokens=block_tokens)
                    if not (np.array_equal(x.cpu().numpy(), want[:, :-1])
                            and np.array_equal(y.cpu().numpy(), want[:, 1:])):
                        raise AssertionError(
                            f"arrival step {step} block_tokens {block_tokens}: "
                            f"batch differs from the token file")
                if step == 0:
                    from repro_torch.data.packing import as_block_permutation, row_gather_index

                    perm = as_block_permutation(g, T)
                    blocks = staged[:perm.shape[0] * T].reshape(-1, T)
                    self.main_inputs["reassemble"] = (
                        blocks, torch.from_numpy(perm).to(self.dev))
                    self.main_inputs["reassemble_tokens"] = (
                        staged, torch.from_numpy(row_gather_index(
                            g, global_batch=B, seq_len=S)).to(self.dev))
                    log(f"arrival: {len(pieces)} pieces, block {T} tokens, "
                        f"arrival order {list(order)}")
        finally:
            ck.close_sync(f)
        counts = dict(K.LAUNCHES)
        self.launches["arrival"] = counts
        log(f"arrival: launches {json.dumps(counts)}")
        for name in ("reassemble", "reassemble_tokens"):
            if counts[name] < 1:
                raise AssertionError(f"arrival: {name} never launched")

    # -- 7 ---------------------------------------------------------------------
    def timing_phase(self):
        import numpy as np
        import torch

        from repro_torch.kernels import reassemble as K
        from repro_torch.kernels import ref

        rng = np.random.default_rng(1)
        dev = self.dev

        def window_case(chunks, kw):
            b, s = kw["global_batch"], kw["seq_len"]
            n_in = min(sum(c.numel() for c in chunks),
                       kw.get("window_tok_off", 0) + b * (s + 1))
            nbytes = 4 * n_in + 2 * 4 * b * s
            return dict(
                kernel=lambda: K.reassemble_window_cuda(chunks, **kw),
                plain=lambda: ref.window_chunks_ref(chunks, **kw),
                library=None, nbytes=nbytes,
                shape=f"B={b} S={s} chunks={len(chunks)}")

        def block_case(src, idx):
            row = src[0].numel() * src.element_size()
            idx64 = idx.long()
            return dict(
                kernel=lambda: K.reassemble_cuda(src, idx),
                plain=lambda: ref.reassemble_ref(src, idx),
                library=lambda: torch.index_select(src, 0, idx64),
                nbytes=2 * idx.numel() * row + 4 * idx.numel(),
                shape=f"src={tuple(src.shape)} {src.dtype} idx={idx.numel()}")

        def tokens_case(staged, row_idx):
            b, s1 = row_idx.shape
            valid = row_idx[row_idx >= 0].clamp(max=staged.numel() - 1)
            n_read = int(torch.unique(valid).numel())
            return dict(
                kernel=lambda: K.reassemble_tokens_cuda(staged, row_idx),
                plain=lambda: ref.tokens_gather_ref(staged, row_idx),
                library=None,
                nbytes=4 * row_idx.numel() + 4 * n_read + 2 * 4 * b * (s1 - 1),
                sector_floor_bytes=tokens_sector_floor_bytes(row_idx),
                shape=f"L={staged.numel()} B={b} S={s1 - 1}")

        cases = {}
        for mode in ("window", "streamed"):
            key = f"reassemble_window/{mode}"
            if key in self.main_inputs:
                cases[key] = window_case(*self.main_inputs[key])
        if "reassemble" in self.main_inputs:
            cases["reassemble/main"] = block_case(*self.main_inputs["reassemble"])
            cases["reassemble_tokens/main"] = tokens_case(
                *self.main_inputs["reassemble_tokens"])
        # 64 MiB windows: B=8192 rows of S+1=2049 int32 tokens.
        bb = 8192
        big = torch.from_numpy(rng.integers(0, 200064, size=bb * (S + 1))
                               .astype(np.int32)).to(dev)
        cases["reassemble_window/64MiB"] = window_case(
            [big], dict(global_batch=bb, seq_len=S))
        # The same window in 16 KiB splinters (4,098 chunks): past the
        # by-value cap, the device-table instance. Building its table takes
        # milliseconds of host time a call, so it is timed behind a longer
        # spin.
        cases["reassemble_window/64MiB_16KiB_chunks"] = window_case(
            split_chunks(big, 4096), dict(global_batch=bb, seq_len=S))
        nb, T = big.numel() // 2049, 2049
        perm = torch.from_numpy(rng.permutation(nb).astype(np.int32)).to(dev)
        cases["reassemble/64MiB"] = block_case(big[:nb * T].reshape(nb, T), perm)
        g = torch.from_numpy(rng.permutation(big.numel()).astype(np.int32)).to(dev)
        cases["reassemble_tokens/64MiB_random"] = tokens_case(
            big, g.reshape(bb, S + 1))
        # The map CkIO hands the kernel: 16 KiB splinters in a shuffled
        # arrival order (runs of 4,096 contiguous staged tokens).
        cases["reassemble_tokens/64MiB_arrival"] = tokens_case(
            big, torch.from_numpy(arrival_row_idx(rng, bb, S, 4096)).to(dev))
        for key, c in cases.items():
            many = key.endswith("_chunks")
            it = 10 if many else 20 if "64MiB" in key else 200
            r = {"shape": c["shape"], "bound_ms": bound_ms(c["nbytes"]),
                 "bytes": c["nbytes"]}
            if "sector_floor_bytes" in c:
                r["sector_floor_ms"] = bound_ms(c["sector_floor_bytes"])
            K.reset_launch_counts()
            times = alternate({"kernel": c["kernel"], "plain": c["plain"]},
                              it, it, 5,
                              800_000_000 if many else 50_000_000)
            r["table_uploads_per_call"] = K.TABLE_UPLOADS / (2 * it + 10)
            r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
            r["library_ms"] = (time_ms(c["library"], it) if c["library"]
                               else None)
            self.timing[key] = r
            log(f"time {key}: {json.dumps(r)}")

    # -- 8 ---------------------------------------------------------------------
    def _close(self, name, got, want, tol) -> None:
        """``got`` within ``tol`` of ``want`` (|g - w| <= tol + tol*|w|, the
        test of np.testing.assert_allclose), in the output dtype."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        err = diff.max().item() if diff.numel() else 0.0
        self.err[name] = max(self.err[name], err)
        if not bool((diff <= tol + tol * w.abs()).all()):
            raise AssertionError(f"{name}: differs from the plain version "
                                 f"beyond {tol} (max abs err {err})")

    def _attn_inputs(self, rng, b, h, kv, sq, sk, hd, dtype):
        import torch

        mk = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.standard_normal(shape).astype("float32")).to(self.dev).to(dtype)
        return mk(b, h, sq, hd), mk(b, kv, sk, hd), mk(b, kv, sk, hd)

    def attention(self):
        import numpy as np
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref

        rng = np.random.default_rng(2)
        cases = [  # (B, H, K, Sq, Sk, hd, causal, window)
            (1, 2, 2, 64, 64, 32, True, 0), (2, 4, 2, 128, 128, 64, True, 0),
            (1, 4, 1, 64, 64, 32, True, 0), (1, 2, 2, 64, 64, 32, True, 16),
            (1, 2, 2, 96, 96, 16, True, 24), (2, 2, 2, 64, 64, 32, False, 0),
            *[(1, H, KV, 1, sk, HD, True, 0) for sk in (1, 17, 129, 2048)],
            (1, H, KV, 2048, 2048, HD, True, 0),
            *[(1, RG_H, RG_KV, 1, sk, RG_HD, True, 0)
              for sk in (1, 17, 129, RG_WINDOW)],
            (1, RG_H, RG_KV, RG_WINDOW, RG_WINDOW, RG_HD, True, RG_WINDOW),
            # The split-key decode path: key counts at the 32-key spans'
            # edges, a window that drops whole spans, and B=4.
            *[(1, h_, kv_, 1, sk, hd_, True, 0) for sk in (63, 64, 65, 2047)
              for h_, kv_, hd_ in ((H, KV, HD), (RG_H, RG_KV, RG_HD))],
            (1, H, KV, 1, 2048, HD, True, 100),
            (1, RG_H, RG_KV, 1, RG_WINDOW, RG_HD, True, 33),
            (4, H, KV, 1, PROMPT + NEW, HD, True, 0),
            (4, RG_H, RG_KV, 1, RG_WINDOW, RG_HD, True, 0),
        ]
        for b, h, kv, sq, sk, hd, causal, window in cases:
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                q, k, v = self._attn_inputs(rng, b, h, kv, sq, sk, hd, dtype)
                self._close("flash_attention",
                            FA.flash_attention_cuda(q, k, v, causal=causal,
                                                    window=window),
                            ref.attention_ref(q, k, v, causal=causal,
                                              window=window), tol)
        torch.cuda.synchronize()
        log(f"attention: {2 * len(cases)} cases within tolerance of the plain "
            f"version; max abs err {self.err['flash_attention']}")

        # A decode row gets the same bits alone and inside a batch of 4, and
        # on every run: the split plan depends on (Sk, hd) only.
        for h, kv, hd, sk in ((H, KV, HD, PROMPT + NEW),
                              (RG_H, RG_KV, RG_HD, RG_WINDOW)):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = self._attn_inputs(rng, 4, h, kv, 1, sk, hd, dtype)
                batch = FA.flash_attention_cuda(q, k, v)
                again = FA.flash_attention_cuda(q, k, v)
                alone = [FA.flash_attention_cuda(q[i:i + 1], k[i:i + 1],
                                                 v[i:i + 1]) for i in range(4)]
                if not (torch.equal(batch, again) and all(
                        torch.equal(batch[i:i + 1], alone[i])
                        for i in range(4))):
                    raise AssertionError(
                        f"flash_attention: decode rows (H={h}, hd={hd}, "
                        f"Sk={sk}, {dtype}) differ between B=1 and B=4 or "
                        f"between runs")
        log("attention: decode rows bit-identical at B=1 and B=4 and across "
            "runs")

        # Time at the served decode shapes (the longest prefix the serve
        # phases reach; recurrentgemma's checked prefixes and full ring
        # too) and at the prefill shapes, bf16 as served.
        for key, h, kv, hd, sq, sk, window in (
                ("decode", H, KV, HD, 1, PROMPT + NEW, 0),
                ("prefill", H, KV, HD, 2048, 2048, 0),
                *[(f"decode_hd256_sk{sk}", RG_H, RG_KV, RG_HD, 1, sk, 0)
                  for sk in (1, 17, 129)],
                ("decode_hd256", RG_H, RG_KV, RG_HD, 1, PROMPT + NEW, 0),
                ("decode_hd256_ring", RG_H, RG_KV, RG_HD, 1, RG_WINDOW, 0),
                ("prefill_hd256", RG_H, RG_KV, RG_HD, RG_WINDOW, RG_WINDOW,
                 RG_WINDOW)):
            q, k, v = self._attn_inputs(rng, 1, h, kv, sq, sk, hd,
                                        torch.bfloat16)
            # Kept (query, key) pairs under the end-aligned causal mask (a
            # window as long as the sequence keeps them all).
            pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))
            flops = 4 * h * hd * pairs
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / BF16_PEAK * 1e3
            r = {"shape": f"B=1 H={h} K={kv} Sq={sq} Sk={sk} hd={hd} bf16 "
                          f"causal window={window}", "bytes": nbytes,
                 "flops": flops, "bound_ms": max(b_bytes, b_ops),
                 "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
            kernel = lambda: FA.flash_attention_cuda(  # noqa: E731
                q, k, v, window=window)
            plain = lambda: ref.attention_ref(q, k, v, window=window)  # noqa: E731
            # The yardstick: one PyTorch call for the same function (for
            # Sq = 1 every key is kept, which is no causal mask; a window
            # as long as the sequence masks nothing more than causal).
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=sq > 1, enable_gqa=True)
            self._close("sdpa", library(), plain(), 2e-2)
            it = 200 if sq == 1 else 20
            times = alternate({"kernel": kernel, "plain": plain}, it, it, 5)
            r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
            r["library_ms"] = time_ms(library, it)
            self.timing[f"flash_attention/{key}"] = r
            log(f"time flash_attention/{key}: {json.dumps(r)}")
        log(f"attention: scaled_dot_product_attention within 2e-2 of the "
            f"plain version; max abs err {self.err['sdpa']}")

    # -- 9 ---------------------------------------------------------------------
    def scan(self):
        import torch

        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ref

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(3)

        def inputs(b, s, d, n, with_h0):
            # Made in place on the card: at the bound's shape Abar and Bx
            # are 8.6 GB each.
            A = torch.randn((b, s, d, n), device=dev, generator=g).sigmoid_()
            Bx = torch.randn((b, s, d, n), device=dev, generator=g).mul_(0.1)
            C = torch.randn((b, s, n), device=dev, generator=g)
            h0 = (torch.randn((b, d, n), device=dev, generator=g).mul_(0.5)
                  if with_h0 else None)
            return A, Bx, C, h0

        cases = [  # (key, B, S, D, N, h0 and h_S)
            *[(None, *c, False) for c in ((1, 32, 16, 4), (2, 64, 32, 8),
                                          (1, 128, 64, 16), (2, 96, 16, 4))],
            ("decode", 1, 1, SSM_D, SSM_N, True),
            (None, 1, SSM_PROMPT, SSM_D, SSM_N, False),
            ("bound", B, S, SSM_D, SSM_N, False),
        ]
        for key, b, s, d, n, with_h0 in cases:
            A, Bx, C, h0 = inputs(b, s, d, n, with_h0)
            y, h = MS.mamba_scan_cuda(A, Bx, C, h0=h0, return_state=with_h0)
            y_ref, h_ref = ref.ssm_scan_ref(A, Bx, C, h0, return_state=True)
            self._close("mamba_scan", y, y_ref, 1e-4)
            if with_h0:
                self._close("mamba_scan", h, h_ref, 1e-4)
            del y, h, y_ref, h_ref
            torch.cuda.synchronize()
            log(f"scan: B={b} S={s} D={d} N={n}{' h0/h_S' if with_h0 else ''}"
                f" within 1e-4 of the plain version; max abs err so far "
                f"{self.err['mamba_scan']}")
            if key is not None:
                # Each input read once, each output written once; FLOPs:
                # an FMA for h and a product and a sum for y per element.
                nbytes = 4 * (2 * b * s * d * n + b * s * n + b * s * d
                              + (2 * b * d * n if with_h0 else 0))
                flops = 4 * b * s * d * n
                b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                b_ops = flops / FP32_PEAK * 1e3
                r = {"shape": f"B={b} S={s} D={d} N={n} fp32"
                              f"{' h0 h_S' if with_h0 else ''}",
                     "bytes": nbytes, "flops": flops,
                     "bound_ms": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "library_ms": None}   # no PyTorch call is a selective scan
                kernel = lambda: MS.mamba_scan_cuda(  # noqa: E731
                    A, Bx, C, h0=h0, return_state=with_h0)
                plain = lambda: ref.ssm_scan_ref(  # noqa: E731
                    A, Bx, C, h0, return_state=with_h0)
                times = alternate({"kernel": kernel, "plain": plain},
                                  *((200, 200, 5) if s == 1 else (5, 2, 1)))
                r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
                self.timing[f"mamba_scan/{key}"] = r
                log(f"time mamba_scan/{key}: {json.dumps(r)}")
            del A, Bx, C, h0
            torch.cuda.empty_cache()
        self._scan_fused()

    def _two_sided(self, nbytes, mufu_ops):
        """The bound of a fused entry: the larger of its bytes over the
        memory rate and its special-function results (ex2, lg2, rcp,
        rsqrt) over their peak, 16 an SM a clock ("operations")."""
        b_bytes = bound_ms(nbytes)
        b_mufu = mufu_ops / (MUFU_PER_SM_CLOCK * self.sm_count
                             * self.sm_clock_hz) * 1e3
        return {"bytes": nbytes, "mufu_ops": mufu_ops, "bytes_ms": b_bytes,
                "mufu_ms": b_mufu, "bound_ms": max(b_bytes, b_mufu),
                "bound_by": "bytes" if b_bytes >= b_mufu else "operations"}

    def _scan_fused(self):
        """The fused entry against its plain version: the sweep shapes with
        proj rows of odd length (no 16-byte alignment) and a strided z, the
        decode shape from a random h0 in bf16 and fp32, a 64-token prefill
        and B=8, S=2048; then its time, the plain version's and that of the
        composition it replaces (the discretization ops, the literal
        kernel, the skip and gate ops), beside the two-sided bound."""
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ref
        from repro_torch.models import ssm

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(6)

        def inputs(b, s, d, n, r, dtype, with_h0, channel_major=False):
            rnd = lambda *shape: torch.randn(  # noqa: E731
                shape, device=dev, generator=g)
            A = torch.arange(1, n + 1, device=dev, dtype=torch.float32)
            return dict(
                xin=(F.silu(rnd(b, d, s)).transpose(1, 2) if channel_major
                     else F.silu(rnd(b, s, d))).to(dtype),
                dt_pre=rnd(b, s, d).mul_(0.5).to(dtype),
                dt_bias=rnd(d).mul_(0.1).add_(math.log(math.expm1(1e-2))),
                A_log=torch.log(A).repeat(d, 1), proj=rnd(b, s, r + 2 * n)
                .to(dtype), Dskip=torch.ones(d, device=dev),
                z=rnd(b, s, 2 * d).to(dtype)[..., d:],
                h0=rnd(b, d, n).mul_(0.5) if with_h0 else None)

        bf16, fp32 = torch.bfloat16, torch.float32
        # (key, B, S, D, N, r, dtype, h0, xin channel-major as the conv
        # leaves it); the last two take the kernel's 16-byte path.
        cases = [
            *[(None, *c, dt, False, False) for c in (
                (1, 32, 16, 4, 3), (2, 64, 32, 8, 5), (1, 128, 64, 16, 1),
                (2, 96, 16, 4, 7)) for dt in (fp32, bf16)],
            ("decode", 1, 1, SSM_D, SSM_N, 256, bf16, True, False),
            (None, 1, 1, SSM_D, SSM_N, 256, fp32, True, False),
            (None, 1, SSM_PROMPT, SSM_D, SSM_N, 256, bf16, False, True),
            ("bound", B, S, SSM_D, SSM_N, 256, bf16, False, False),
        ]
        for key, b, s, d, n, r, dtype, with_h0, cmajor in cases:
            t = inputs(b, s, d, n, r, dtype, with_h0, cmajor)
            h0 = t.pop("h0")
            args = tuple(t.values())
            tol = 1e-4 if dtype == fp32 else 2e-2
            y, h = MS.mamba_scan_fused_cuda(*args, h0=h0, return_state=True)
            y_ref, h_ref = ref.mamba_scan_fused_ref(*args, h0,
                                                    return_state=True)
            self._close("mamba_scan_fused", y, y_ref, tol)
            self._close("mamba_scan_fused", h, h_ref, 1e-4)
            del y, h, y_ref, h_ref
            torch.cuda.synchronize()
            log(f"scan fused: B={b} S={s} D={d} N={n} r={r} {dtype}"
                f"{' h0' if with_h0 else ''}"
                f"{' xin channel-major' if cmajor else ''}: y within {tol}, "
                f"h_S within "
                f"1e-4 of the plain version; max abs err so far "
                f"{self.err['mamba_scan_fused']}")
            if key is None:
                continue
            e = t["xin"].element_size()
            nbytes = (e * (4 * b * s * d + 2 * n * b * s) + 4 * (2 * d + d * n)
                      + (8 * b * d * n if with_h0 else 0))
            r_ = {"shape": f"B={b} S={s} D={d} N={n} r={r} {dtype}"
                           f"{' h0 h_S' if with_h0 else ''}",
                  **self._two_sided(nbytes, b * s * d * n + 4 * b * s * d
                                    + d * n),
                  "library_ms": None}   # no PyTorch call is a selective scan

            def composed():
                Abar, Bx, Cc = ssm.discretize(
                    t["dt_pre"], t["dt_bias"], t["A_log"], t["proj"],
                    t["xin"])
                y, _ = MS.mamba_scan_cuda(Abar, Bx, Cc, h0=h0,
                                          return_state=with_h0)
                y = y.to(dtype) + t["Dskip"].to(dtype) * t["xin"]
                return y * F.silu(t["z"])

            times = alternate({
                "kernel": lambda: MS.mamba_scan_fused_cuda(
                    *args, h0=h0, return_state=with_h0),
                "plain": lambda: ref.mamba_scan_fused_ref(
                    *args, h0, return_state=with_h0),
                "composed": composed},
                *((200, 200, 5) if s == 1 else (20, 2, 1)))
            r_["ms"], r_["plain_ms"] = times["kernel"], times["plain"]
            r_["composed_ms"] = times["composed"]
            self.timing[f"mamba_scan_fused/{key}"] = r_
            log(f"time mamba_scan_fused/{key}: {json.dumps(r_)}")
            del t, args, h0
            torch.cuda.empty_cache()

    # -- 10 --------------------------------------------------------------------
    def lru(self):
        import torch

        from repro_torch.kernels import ref
        from repro_torch.kernels import rglru_scan as LRU

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        cases = [  # (key, B, S, W, h0)
            *[(None, *c, False) for c in ((1, 32, 16), (2, 64, 64),
                                          (1, 256, 32), (3, 37, 50))],
            ("decode", 1, 1, RG_W, True),
            (None, 1, WRAP_PROMPT, RG_W, False),
            ("bound", B, S, RG_W, False),
        ]
        for key, b, s, w, with_h0 in cases:
            a = torch.randn((b, s, w), device=dev, generator=g).sigmoid_()
            x = torch.randn((b, s, w), device=dev, generator=g).mul_(0.1)
            h0 = (torch.randn((b, w), device=dev, generator=g).mul_(0.5)
                  if with_h0 else None)
            self._close("rglru_scan", LRU.rglru_scan_cuda(a, x, h0=h0),
                        ref.lru_scan_ref(a, x, h0), 1e-5)
            torch.cuda.synchronize()
            log(f"lru: B={b} S={s} W={w}{' h0' if with_h0 else ''} within "
                f"1e-5 of the plain version; max abs err so far "
                f"{self.err['rglru_scan']}")
            if key is None:
                continue
            # a and b read once, h written once (and h0 read); one FMA an
            # element.
            nbytes = 4 * (3 * b * s * w + (b * w if with_h0 else 0))
            flops = 2 * b * s * w
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / FP32_PEAK * 1e3
            r = {"shape": f"B={b} S={s} W={w} fp32{' h0' if with_h0 else ''}",
                 "bytes": nbytes, "flops": flops,
                 "bound_ms": max(b_bytes, b_ops),
                 "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                 # No PyTorch call computes this recurrence: a cumprod /
                 # cumsum rewrite divides by a vanishing product.
                 "library_ms": None}
            kernel = lambda: LRU.rglru_scan_cuda(a, x, h0=h0)  # noqa: E731
            plain = lambda: ref.lru_scan_ref(a, x, h0)  # noqa: E731
            times = alternate({"kernel": kernel, "plain": plain},
                              *((200, 200, 5) if s == 1 else (20, 2, 1)))
            r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
            self.timing[f"rglru_scan/{key}"] = r
            log(f"time rglru_scan/{key}: {json.dumps(r)}")
        self._lru_gated()

    def _lru_gated(self):
        """The gated entry against its plain version: the sweep shapes, a
        ragged one, the decode shape from a random h0 in bf16 and fp32, a
        2100-token prefill and B=8, S=2048, xr channel-major as the conv
        leaves it; then its time, the plain version's and that of the
        composition it replaces (the gate ops, the literal kernel, the
        output product), beside the two-sided bound."""
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import ref
        from repro_torch.kernels import rglru_scan as LRU

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(7)

        def inputs(b, s, w, dtype, with_h0):
            rnd = lambda *shape: torch.randn(  # noqa: E731
                shape, device=dev, generator=g)
            lam = torch.log(torch.expm1(-torch.log(torch.linspace(
                0.9, 0.999, w, device=dev)) / 8.0))
            return dict(
                r_pre=rnd(b, s, w), i_pre=rnd(b, s, w),
                b_r=rnd(w).mul_(0.1), b_i=rnd(w).mul_(0.1), lam=lam,
                xr=rnd(b, w, s).to(dtype).transpose(1, 2),
                gate=F.gelu(rnd(b, s, w), approximate="tanh").to(dtype),
                h0=rnd(b, w).mul_(0.5) if with_h0 else None)

        bf16, fp32 = torch.bfloat16, torch.float32
        cases = [  # (key, B, S, W, dtype, h0)
            *[(None, *c, dt, False) for c in (
                (1, 32, 16), (2, 64, 64), (1, 256, 32), (3, 37, 50))
              for dt in (fp32, bf16)],
            ("decode", 1, 1, RG_W, bf16, True),
            (None, 1, 1, RG_W, fp32, True),
            (None, 1, WRAP_PROMPT, RG_W, bf16, False),
            ("bound", B, S, RG_W, bf16, False),
        ]
        for key, b, s, w, dtype, with_h0 in cases:
            t = inputs(b, s, w, dtype, with_h0)
            h0 = t.pop("h0")
            args = tuple(t.values())
            tol = 1e-5 if dtype == fp32 else 2e-2
            y, h = LRU.rglru_scan_gated_cuda(*args, h0=h0, return_state=True)
            y_ref, h_ref = ref.rglru_scan_gated_ref(*args, h0,
                                                    return_state=True)
            self._close("rglru_scan_gated", y, y_ref, tol)
            self._close("rglru_scan_gated", h, h_ref, 1e-5)
            torch.cuda.synchronize()
            log(f"lru gated: B={b} S={s} W={w} {dtype}"
                f"{' h0' if with_h0 else ''}: y within {tol}, h_S within "
                f"1e-5 of the plain version; max abs err so far "
                f"{self.err['rglru_scan_gated']}")
            if key is None:
                continue
            e = t["xr"].element_size()
            nbytes = ((8 + 3 * e) * b * s * w + 12 * w
                      + (8 * b * w if with_h0 else 0))
            r_ = {"shape": f"B={b} S={s} W={w} {dtype}"
                           f"{' h0 h_S' if with_h0 else ''}",
                  # two sigmoids (exp, rcp), exp(log_a), exp(2 log_a), sqrt
                  **self._two_sided(nbytes, 7 * b * s * w + 2 * w),
                  # No PyTorch call computes the recurrence.
                  "library_ms": None}

            def composed():
                xf = t["xr"].float()
                r = torch.sigmoid(t["r_pre"] + t["b_r"])
                i = torch.sigmoid(t["i_pre"] + t["b_i"])
                log_a = -8.0 * F.softplus(t["lam"]) * r
                beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                              min=1e-12))
                hh = LRU.rglru_scan_cuda(torch.exp(log_a).contiguous(),
                                         (beta * i * xf).contiguous(), h0=h0)
                return hh.to(dtype) * t["gate"]

            times = alternate({
                "kernel": lambda: LRU.rglru_scan_gated_cuda(
                    *args, h0=h0, return_state=with_h0),
                "plain": lambda: ref.rglru_scan_gated_ref(
                    *args, h0, return_state=with_h0),
                "composed": composed},
                *((200, 200, 5) if s == 1 else (20, 2, 1)))
            r_["ms"], r_["plain_ms"] = times["kernel"], times["plain"]
            r_["composed_ms"] = times["composed"]
            self.timing[f"rglru_scan_gated/{key}"] = r_
            log(f"time rglru_scan_gated/{key}: {json.dumps(r_)}")
            del t, args, h0
            torch.cuda.empty_cache()

    # -- 11, 12, 13 ------------------------------------------------------------
    def _serve_arch(self, arch, *, prompt_len, new, static_requests,
                    cont_requests, kmod, kfn, kname, want, check,
                    kernels=None, prefill=None):
        """Serve ``arch`` at full width through ``launch.serve``, static
        and continuous, with random weights from seed 0. ``kmod.kfn`` is
        the wrapper of a kernel the decode call launches (``kname`` in
        ``kmod.LAUNCHES``); the first call whose arguments satisfy ``want``
        is captured and handed to ``check`` after the run. ``kernels``
        maps each kernel name to its module and its launches per decode
        call (default: ``kname``, once a layer). ``prefill`` maps a kernel
        name to its module and its launches per prefill forward, counted
        over the decode-replay check's two prefill forwards. Returns the
        launches of both modes (and of those forwards) by kernel."""
        import numpy as np
        import torch

        from repro_torch.configs.registry import get_config
        from repro_torch.launch import serve as L
        from repro_torch.models import build_model, transformer
        from repro_torch.serve import sequential_oracle

        cfg = get_config(arch)
        model = build_model(cfg)
        kernels = kernels or {kname: (kmod, cfg.num_layers)}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(0, device=self.dev)
        torch.cuda.synchronize()
        n_params = cfg.param_counts()["total"]
        log(f"serve {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B params in fp32 ({4 * n_params / 1e9:.2f}"
            f" GB), bf16 compute; weights made in "
            f"{time.perf_counter() - t0:.1f} s")
        base = ["--arch", cfg.name, "--batch", str(SLOTS), "--prompt-len",
                str(prompt_len), "--max-new", str(new), "--data",
                os.path.join(self.tmp, f"prompts_{arch}.bin")]
        modes = {
            "static": base + ["--requests", str(static_requests)],
            "continuous": base + ["--requests", str(cont_requests),
                                  "--continuous", "--arrival-rate",
                                  str(ARRIVAL_RATE)],
        }
        decode_step = transformer.decode_step
        wrapper = getattr(kmod, kfn)
        calls = [0]
        captured = {}

        def counting(*a, **kw):
            calls[0] += 1
            return decode_step(*a, **kw)

        def capture(*a, **kw):
            if not captured and want(*a, **kw):
                captured.update(
                    args=[x.clone() for x in a],
                    kw={k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in kw.items()})
            return wrapper(*a, **kw)

        runs, counts = {}, {}
        transformer.decode_step = counting
        setattr(kmod, kfn, capture)
        try:
            for mode, argv in modes.items():
                torch.cuda.synchronize()
                for mod, _ in kernels.values():
                    mod.reset_launch_counts()
                calls[0] = 0
                t = time.perf_counter()
                runs[mode] = L.main(argv, params=params)
                torch.cuda.synchronize()
                counts[mode] = ({k: m.LAUNCHES[k]
                                 for k, (m, _) in kernels.items()},
                                calls[0], time.perf_counter() - t)
        finally:
            transformer.decode_step = decode_step
            setattr(kmod, kfn, wrapper)
        # -- checks -------------------------------------------------------------
        for mode, (launches, n_calls, wall) in counts.items():
            run = runs[mode]
            for k, (_, n) in kernels.items():
                if launches[k] != n * n_calls or n_calls == 0:
                    raise AssertionError(
                        f"serve {arch} {mode}: {k} launched {launches[k]} "
                        f"times in {n_calls} decode calls, not {n} a call")
            toks = [list(np.asarray(r.result)) for r in run.requests]
            if not (run.summary["all_completed"] and all(
                    len(t) == new and all(0 <= x < cfg.vocab_size for x in t)
                    for t in toks)):
                raise AssertionError(f"serve {arch} {mode}: {run.summary}")
            log(f"serve {arch} {mode}: {len(toks)} requests, "
                f"{run.summary['new_tokens']} new tokens in "
                f"{run.summary['total_s']} s = {run.summary['tok_per_s']} "
                f"tokens/s; {n_calls} decode calls in {wall:.2f} s = "
                f"{wall / n_calls * 1e3:.2f} ms a call (host clock, mode wall"
                f" time over calls); launches "
                + ", ".join(f"{k} {launches[k]} = {n} x {n_calls}"
                            for k, (_, n) in kernels.items()))
        cont = runs["continuous"]
        for which in ("first_token", "e2e"):
            p = cont.metrics.latency_percentiles(which)
            log(f"serve {arch} continuous: arrival -> {which} p50 "
                f"{p['p50']:.4f} s, p99 {p['p99']:.4f} s")
        by_rid = sorted(cont.requests, key=lambda r: r.rid)
        prompts = [cont.corpus[r.row_start:r.row_start + r.num_rows]
                   for r in by_rid]
        oracle = sequential_oracle(cont.engine, prompts, [new] * len(by_rid))
        if [r.result for r in by_rid] != oracle:
            raise AssertionError(f"serve {arch} continuous: tokens differ "
                                 f"from the sequential oracle on the same "
                                 f"engine")
        log(f"serve {arch} continuous: {len(by_rid)} token streams "
            f"bit-identical to the sequential oracle")
        log(f"serve {arch}: captured decode inputs "
            f"{check(wrapper, *captured['args'], **captured['kw'])}")
        # Decode replay of one prompt against the plain prefill forward, in
        # bf16 as served and in fp32, then the time of a synchronized B=1
        # decode call past the prompt (bf16).
        prompt = torch.from_numpy(prompts[0].astype(np.int32)).to(self.dev)[None]
        prefill = prefill or {}
        pre_counts = {k: 0 for k in prefill}
        for dtype, tol in PREFILL_REL_TOL.items():
            m = build_model(cfg.replace(dtype=dtype))
            with torch.no_grad():
                state = m.init_decode_state(params, 1, prompt_len + new)
                for t in range(prompt_len):
                    logits, state = m.decode(params, state,
                                             {"tokens": prompt[:, t:t + 1]})
                torch.cuda.synchronize()
                for mod, _ in prefill.values():
                    mod.reset_launch_counts()
                pre = m.prefill_logits(params, {"tokens": prompt})
                torch.cuda.synchronize()
                for k, (mod, _) in prefill.items():
                    pre_counts[k] += mod.LAUNCHES[k]
            a, b = logits.float(), pre.float()
            rel = ((a - b).norm() / b.norm()).item()
            log(f"serve {arch}: {dtype} decode-replay logits vs prefill "
                f"logits: relative L2 {rel:.3e} (bound {tol}), max abs "
                f"{(a - b).abs().max().item():.3e}, |logit| max "
                f"{b.abs().max().item():.3f}, same argmax "
                f"{bool(a.argmax() == b.argmax())}")
            if not (rel <= tol and bool(torch.isfinite(a).all())):
                raise AssertionError(f"serve {arch}: {dtype} decode replay "
                                     f"differs from prefill (relative L2 "
                                     f"{rel})")
            if dtype != cfg.dtype:
                continue
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                for _ in range(new):
                    logits, state = m.decode(params, state, {"tokens": tok})
                    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            per_call = (time.perf_counter() - t) / new
            log(f"serve {arch}: B=1 {dtype} decode call at positions "
                f"{prompt_len}-{prompt_len + new - 1}: {per_call * 1e3:.2f} "
                f"ms (host clock, synchronized) = {1 / per_call:.1f} tokens/s"
                f" a stream; it reads the {4 * n_params / 1e9:.2f} GB of "
                f"fp32 weights -> >= {4 * n_params / HBM_BYTES_PER_S * 1e3:.2f}"
                f" ms at 3.35 TB/s")
        for k, (_, n) in prefill.items():
            n_fwd = len(PREFILL_REL_TOL)
            if pre_counts[k] != n * n_fwd:
                raise AssertionError(f"serve {arch}: {k} launched "
                                     f"{pre_counts[k]} times in {n_fwd} "
                                     f"prefill forwards, not {n} each")
            log(f"serve {arch}: prefill forwards launched {k} "
                f"{pre_counts[k]} = {n} x {n_fwd}")
        peak = torch.cuda.max_memory_allocated()
        log(f"serve {arch}: max_memory_allocated {peak / 2**30:.2f} GiB")
        if peak >= 80e9:
            raise AssertionError(f"serve {arch}: peak memory {peak} B")
        del params, runs, cont, state, logits, pre, a, b
        torch.cuda.empty_cache()
        total = {k: sum(c[0][k] for c in counts.values()) for k in kernels}
        for k, v in pre_counts.items():
            total[k] = total.get(k, 0) + v
        return total

    def serve(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref

        def check(fa, q, k, v, **kw):
            self._close("flash_attention", fa(q, k, v, **kw),
                        ref.attention_ref(q, k, v, **kw), 2e-2)
            return (f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}: "
                    f"kernel within 2e-2 of the plain version")

        # One layer's served decode inputs at the longest prefix (B=1).
        self.launches["serve"] = self._serve_arch(
            "phi4-mini-3.8b", prompt_len=PROMPT, new=NEW,
            static_requests=STATIC_REQUESTS, cont_requests=CONT_REQUESTS,
            kmod=FA, kfn="flash_attention_cuda", kname="flash_attention",
            want=lambda q, k, v, **kw: (q.shape[0] == 1
                                        and k.shape[2] == PROMPT + NEW),
            check=check)

    def serve_ssm(self):
        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ref

        def check(scan, *args, **kw):
            y, h = scan(*args, **kw)
            y_ref, h_ref = ref.mamba_scan_fused_ref(*args, kw["h0"],
                                                    return_state=True)
            self._close("mamba_scan_fused", y, y_ref, 2e-2)
            self._close("mamba_scan_fused", h, h_ref, 1e-4)
            return (f"xin {tuple(args[0].shape)} {args[0].dtype} with h0: "
                    f"kernel within 2e-2 (y) and 1e-4 (h_S) of the plain "
                    f"version")

        # One layer's served decode inputs past the prompt (B=1, S=1).
        served = [0]

        def want(xin, *a, **kw):
            if xin.shape[:2] != (1, 1):
                return False
            served[0] += 1
            return served[0] > 64 * SSM_PROMPT

        # A decode call runs the fused kernel once a layer and the literal
        # one never; the prefill forward ("materialized", the config's
        # ssm_impl) runs the literal kernel once a layer.
        self.launches["serve_ssm"] = self._serve_arch(
            "falcon-mamba-7b", prompt_len=SSM_PROMPT, new=NEW,
            static_requests=SSM_STATIC_REQUESTS,
            cont_requests=SSM_CONT_REQUESTS, kmod=MS,
            kfn="mamba_scan_fused_cuda", kname="mamba_scan_fused", want=want,
            check=check,
            kernels={"mamba_scan_fused": (MS, 64), "mamba_scan": (MS, 0)},
            prefill={"mamba_scan": (MS, 64)})

    def serve_hybrid(self):
        from repro_torch.configs.base import RGLRU
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref
        from repro_torch.kernels import rglru_scan as LRU

        schedule = get_config("recurrentgemma-2b").layer_schedule()
        n_rec = sum(spec.mixer == RGLRU for spec in schedule)
        if (n_rec, len(schedule) - n_rec) != (RG_REC, RG_LOC):
            raise AssertionError(f"recurrentgemma-2b: {n_rec} RG-LRU layers "
                                 f"of {len(schedule)}")

        def check(scan, *args, **kw):
            y, h = scan(*args, **kw)
            y_ref, h_ref = ref.rglru_scan_gated_ref(*args, kw["h0"],
                                                    return_state=True)
            self._close("rglru_scan_gated", y, y_ref, 2e-2)
            self._close("rglru_scan_gated", h, h_ref, 1e-5)
            return (f"xr {tuple(args[5].shape)} {args[5].dtype} with h0: "
                    f"kernel within 2e-2 (y) and 1e-5 (h_S) of the plain "
                    f"version")

        # One layer's served decode inputs past the prompt (B=1, S=1).
        served = [0]

        def want(r_pre, *a, **kw):
            if r_pre.shape[:2] != (1, 1):
                return False
            served[0] += 1
            return served[0] > n_rec * PROMPT

        self.launches["serve_hybrid"] = self._serve_arch(
            "recurrentgemma-2b", prompt_len=PROMPT, new=NEW,
            static_requests=STATIC_REQUESTS, cont_requests=CONT_REQUESTS,
            kmod=LRU, kfn="rglru_scan_gated_cuda", kname="rglru_scan_gated",
            want=want, check=check,
            kernels={"rglru_scan_gated": (LRU, RG_REC),
                     "rglru_scan": (LRU, 0),
                     "flash_attention": (FA, RG_LOC)})
        self._ring_wrap()

    def _ring_wrap(self):
        """The first WRAP_LAYERS layers of recurrentgemma-2b at full width
        in fp32: one WRAP_PROMPT-token prompt replayed through decode, so
        that every local layer's 2048-slot ring wraps, against the plain
        prefill forward, which masks the window explicitly."""
        import numpy as np
        import torch

        from repro_torch.configs.base import ATTN_LOCAL
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import rglru_scan as LRU
        from repro_torch.models import build_model

        cfg = get_config("recurrentgemma-2b").replace(
            num_layers=WRAP_LAYERS, dtype="float32")
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        n_att = sum(spec.mixer == ATTN_LOCAL for spec in cfg.layer_schedule())
        prompt = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, size=(1, WRAP_PROMPT)).astype(np.int32)).to(
                self.dev)
        torch.cuda.synchronize()
        FA.reset_launch_counts()
        LRU.reset_launch_counts()
        t = time.perf_counter()
        with torch.no_grad():
            state = model.init_decode_state(params, 1, WRAP_PROMPT)
            for i in range(WRAP_PROMPT):
                logits, state = model.decode(params, state,
                                             {"tokens": prompt[:, i:i + 1]})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = {"rglru_scan_gated": LRU.LAUNCHES["rglru_scan_gated"],
                      "rglru_scan": LRU.LAUNCHES["rglru_scan"],
                      "flash_attention": FA.LAUNCHES["flash_attention"]}
            pre = model.prefill_logits(params, {"tokens": prompt})
        rings = [st.k.shape[1] for st in state.layers if hasattr(st, "k")]
        want = {"rglru_scan_gated": (WRAP_LAYERS - n_att) * WRAP_PROMPT,
                "rglru_scan": 0, "flash_attention": n_att * WRAP_PROMPT}
        if rings != [RG_WINDOW] * n_att or counts != want:
            raise AssertionError(f"ring wrap: rings {rings}, launches "
                                 f"{counts} (want {want})")
        self.launches["ring_wrap"] = counts
        a, b = logits.float(), pre.float()
        rel = ((a - b).norm() / b.norm()).item()
        log(f"ring wrap: {WRAP_LAYERS} layers ({n_att} local, rings of "
            f"{RG_WINDOW} slots), fp32, a {WRAP_PROMPT}-token prompt replayed "
            f"through decode in {wall:.1f} s ({wall / WRAP_PROMPT * 1e3:.2f} ms"
            f" a call, host clock); launches {json.dumps(counts)}; last "
            f"logits vs the prefill forward: relative L2 {rel:.3e} (bound "
            f"{PREFILL_REL_TOL['float32']}), max abs "
            f"{(a - b).abs().max().item():.3e}, same argmax "
            f"{bool(a.argmax() == b.argmax())}")
        del params, state, logits, pre, a, b
        torch.cuda.empty_cache()
        if not rel <= PREFILL_REL_TOL["float32"]:
            raise AssertionError(f"ring wrap: decode replay differs from "
                                 f"prefill (relative L2 {rel})")

    # -- result ----------------------------------------------------------------
    def kernel_line(self):
        launches = {}
        for counts in self.launches.values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        main_key = {"reassemble_window": "reassemble_window/window",
                    "reassemble": "reassemble/main",
                    "reassemble_tokens": "reassemble_tokens/main",
                    "flash_attention": "flash_attention/decode",
                    "mamba_scan": "mamba_scan/decode",
                    "rglru_scan": "rglru_scan/decode",
                    "mamba_scan_fused": "mamba_scan_fused/decode",
                    "rglru_scan_gated": "rglru_scan_gated/decode"}
        out = []
        for name, key in main_key.items():
            r = self.timing[key]
            out.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": self.err[name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r.get("bound_by", "bytes"),
                "library_ms": r["library_ms"],
                **({"fuses": FUSES[name]} if name in FUSES else {}),
            })
        return {"kernels": out}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not importable", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sm = Smoke()
    t0 = time.perf_counter()
    try:
        sm.phase("card", sm.card)
        sm.phase("build", sm.build)
        if not sm.failed:
            sm.phase("kernels", sm.kernels)
            sm.phase("window", lambda: sm.main_path(streaming=False))
            sm.phase("streamed", sm.streamed)
            sm.phase("arrival", sm.arrival)
            sm.phase("timing", sm.timing_phase)
            sm.phase("attention", sm.attention)
            sm.phase("scan", sm.scan)
            sm.phase("lru", sm.lru)
            sm.phase("serve", sm.serve)
            sm.phase("serve_ssm", sm.serve_ssm)
            sm.phase("serve_hybrid", sm.serve_hybrid)
            if "--profile" in sys.argv[1:]:
                sm.phase("profile", sm.profile)
    finally:
        shutil.rmtree(sm.tmp, ignore_errors=True)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if sm.failed:
        log(f"FAILED phases: {sm.failed}")
        return 1
    print(sm.card_line)
    print(json.dumps(sm.kernel_line()))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
