#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (each failure is reported; any failure exits 1 and prints no result):

1. card      the card's name and power limit, as nvidia-smi reports them;
2. build     nvcc builds every ``kernels/csrc/*.cu`` into ``build/`` (one
             nvcc per source, all started together);
3. kernels   every reassembly kernel against its plain PyTorch version on the
             card, bit-equal, over aligned/unaligned window offsets,
             remainder windows, 1- and many-chunk tables, block gathers in
             f32/bf16/int32 (2-D and 3-D, with repeats) and token gathers with
             pads;
4. window    the main path, whole-window device ingest: a uint32 synthetic
             corpus -> ``CkIOPipeline(streaming=False).get_batch_device`` ->
             the microbatched AdamW step of phi4-mini-3.8b at full width
             (d_model 3072, 24/8 heads, head_dim 128, d_ff 8192, vocab
             200,064, tied embeddings) with 4 of its 32 layers, random
             weights from a seed; global batch 8, seq 2048, 4 microbatches,
             4 steps;
5. streamed  the same with ``streaming=True``; batches must be bit-equal to
             phase 4's;
6. arrival   ``ops.device_ingest`` over arrival-ordered stagings of the
             corpus's step windows, as a CkIO session delivered them (block
             permutation and token-map layouts): the entry point that reaches
             the block and token gather kernels;
7. timing    each kernel, its plain version and, where one exists, a single
             PyTorch call for the same function, at the main-path shapes and
             at a 64 MiB window, beside the bytes bound (3.35 TB/s);
8. attention the flash-attention kernel against its plain version on the
             card (fp32 at 1e-5, bf16 at 2e-2): the six sweep cases of
             tests/test_kernels.py, phi4-mini decode shapes (Sq=1, H=24,
             K=8, hd=128, Sk in 1/17/129/2048) and a 2048-token causal
             prefill; then its time, the plain version's and
             ``scaled_dot_product_attention``'s at the served decode shape
             and at the prefill shape, beside the bound;
9. serve     the second main path, ``repro_torch.launch.serve``: phi4-mini
             at full width with all 32 layers, random weights from seed 0,
             bf16 compute; static mode (BatchServer over one CkIO bulk read,
             4 requests, batch 4) and continuous mode (a 3-shard FileSet,
             3 requests, 4 slots, Poisson arrivals), 128 prompt tokens and
             16 new tokens a request. Every decode call runs the attention
             of each of the 32 layers through the kernel; continuous tokens
             must equal the sequential oracle's on the same engine, and
             replaying a prompt through decode must give the logits of the
             plain prefill forward;
10. profile  only with ``--profile``: two whole-window main-path steps, and
             16 B=1 decode calls of the 32-layer model, under
             ``torch.profiler`` (device busy share, kernels by device time).

The launch counts are zeroed just before each main-path run (phases 4-6 and
each mode of phase 9) and read just after it. The line before the last is a
JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
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
SOURCES = {
    "reassemble_window": "src/repro_torch/kernels/csrc/reassemble.cu",
    "reassemble": "src/repro_torch/kernels/csrc/reassemble.cu",
    "reassemble_tokens": "src/repro_torch/kernels/csrc/reassemble.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
REPLACES = {
    "reassemble_window": "src/repro/kernels/reassemble.py:81",
    "reassemble": "src/repro/kernels/reassemble.py:52",
    "reassemble_tokens": "src/repro/kernels/reassemble.py:173",
    "flash_attention": "src/repro/kernels/flash_attention.py:90",
}
ARCH_LAYERS = 4
B, S, MICROBATCHES, STEPS = 8, 2048, 4, 4
# Serving: prompt and new tokens per request, requests per mode, slots.
PROMPT, NEW, STATIC_REQUESTS, CONT_REQUESTS, SLOTS = 128, 16, 4, 3, 4
ARRIVAL_RATE = 1.0                 # Poisson arrivals, requests/s
H, KV, HD = 24, 8, 128             # phi4-mini attention heads
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


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, from
    CUDA events around the whole run. A ~25 ms spin kernel queued first lets
    the host enqueue the calls ahead of the device, so that a call's host
    cost (Python, ctypes, allocation) is not timed as device time, as long
    as all ``iters`` calls are enqueued within the spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.failed = []
        # Kernel against plain version, by kernel; "sdpa" holds the check
        # of the library yardstick against the plain version, apart.
        self.err = {"reassemble_window": 0, "reassemble": 0,
                    "reassemble_tokens": 0, "flash_attention": 0, "sdpa": 0}
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
        log(f"{mode}: launches {json.dumps(counts)}")

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
        replayed through decode on the 32-layer model, then ``NEW`` B=1
        bf16 decode calls under the profiler. Prints the device busy share
        and the kernels by device time of each, and writes the full tables
        to ``profile_window.txt`` and ``profile_decode.txt``."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.configs.registry import get_config
        from repro_torch.models import build_model

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

        cfg = get_config("phi4-mini-3.8b")
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        tok = torch.arange(PROMPT, dtype=torch.int32, device=self.dev)[None]
        with torch.no_grad():
            state = model.init_decode_state(params, 1, PROMPT + NEW)
            for t in range(PROMPT):
                logits, state = model.decode(params, state,
                                             {"tokens": tok[:, t:t + 1]})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                for _ in range(NEW):
                    nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                    logits, state = model.decode(params, state,
                                                 {"tokens": nxt})
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del params, state, logits
        torch.cuda.empty_cache()
        self._report_profile(prof, wall, NEW, "decode call",
                             "profile_decode.txt")

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
        log(f"profile: {n} {unit}s, {wall * 1e3:.1f} ms wall under the "
            f"profiler (host clock), device busy {busy * 1e3:.1f} ms = "
            f"{busy / wall:.3f} of wall")
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
        nb, T = big.numel() // 2049, 2049
        perm = torch.from_numpy(rng.permutation(nb).astype(np.int32)).to(dev)
        cases["reassemble/64MiB"] = block_case(big[:nb * T].reshape(nb, T), perm)
        g = torch.from_numpy(rng.permutation(big.numel()).astype(np.int32)).to(dev)
        cases["reassemble_tokens/64MiB"] = tokens_case(
            big, g.reshape(bb, S + 1))
        for key, c in cases.items():
            big_case = key.endswith("64MiB")
            it = 20 if big_case else 200
            r = {"shape": c["shape"], "bound_ms": bound_ms(c["nbytes"]),
                 "bytes": c["nbytes"]}
            # kernel, plain, plain, kernel: alternate within one call
            k1 = time_ms(c["kernel"], it)
            p1 = time_ms(c["plain"], it)
            p2 = time_ms(c["plain"], it)
            k2 = time_ms(c["kernel"], it)
            r["ms"], r["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
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

        # Time at the served decode shape (the longest prefix the serve
        # phase reaches) and at the prefill shape, bf16 as served.
        for key, sq, sk in (("decode", 1, PROMPT + NEW), ("prefill", 2048, 2048)):
            q, k, v = self._attn_inputs(rng, 1, H, KV, sq, sk, HD,
                                        torch.bfloat16)
            # Kept (query, key) pairs under the end-aligned causal mask.
            pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))
            flops = 4 * H * HD * pairs
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / BF16_PEAK * 1e3
            r = {"shape": f"B=1 H={H} K={KV} Sq={sq} Sk={sk} hd={HD} bf16 "
                          f"causal", "bytes": nbytes, "flops": flops,
                 "bound_ms": max(b_bytes, b_ops),
                 "bound_by": "bytes" if b_bytes >= b_ops else "operations"}
            kernel = lambda: FA.flash_attention_cuda(q, k, v)  # noqa: E731
            plain = lambda: ref.attention_ref(q, k, v)  # noqa: E731
            # The yardstick: one PyTorch call for the same function (for
            # Sq = 1 every key is kept, which is no causal mask).
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=sq > 1, enable_gqa=True)
            self._close("sdpa", library(), plain(), 2e-2)
            it = 200 if sq == 1 else 20
            k1, p1, p2, k2 = (time_ms(kernel, it), time_ms(plain, it),
                              time_ms(plain, it), time_ms(kernel, it))
            r["ms"], r["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
            r["library_ms"] = time_ms(library, it)
            self.timing[f"flash_attention/{key}"] = r
            log(f"time flash_attention/{key}: {json.dumps(r)}")
        log(f"attention: scaled_dot_product_attention within 2e-2 of the "
            f"plain version; max abs err {self.err['sdpa']}")

    # -- 9 ---------------------------------------------------------------------
    def serve(self):
        import numpy as np
        import torch

        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref
        from repro_torch.launch import serve as L
        from repro_torch.models import build_model, transformer
        from repro_torch.serve import sequential_oracle

        cfg = get_config("phi4-mini-3.8b")
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(0, device=self.dev)
        torch.cuda.synchronize()
        n_params = cfg.param_counts()["total"]
        log(f"serve: {cfg.name}, {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f} B params in fp32 "
            f"({4 * n_params / 1e9:.2f} GB), bf16 compute; weights made in "
            f"{time.perf_counter() - t0:.1f} s")
        base = ["--arch", cfg.name, "--batch", str(SLOTS), "--prompt-len",
                str(PROMPT), "--max-new", str(NEW), "--data",
                os.path.join(self.tmp, "prompts.bin")]
        modes = {
            "static": base + ["--requests", str(STATIC_REQUESTS)],
            "continuous": base + ["--requests", str(CONT_REQUESTS),
                                  "--continuous", "--arrival-rate",
                                  str(ARRIVAL_RATE)],
        }
        decode_step = transformer.decode_step
        fa = FA.flash_attention_cuda
        calls = [0]
        captured = {}

        def counting(*a, **kw):
            calls[0] += 1
            return decode_step(*a, **kw)

        def capture(q, k, v, **kw):
            # One layer's served decode inputs at the longest prefix (B=1).
            if not captured and q.shape[0] == 1 and k.shape[2] == PROMPT + NEW:
                captured.update(args=(q.clone(), k.clone(), v.clone()), kw=kw)
            return fa(q, k, v, **kw)

        runs, counts = {}, {}
        transformer.decode_step = counting
        FA.flash_attention_cuda = capture
        try:
            for mode, argv in modes.items():
                torch.cuda.synchronize()
                FA.reset_launch_counts()
                calls[0] = 0
                t = time.perf_counter()
                runs[mode] = L.main(argv, params=params)
                torch.cuda.synchronize()
                counts[mode] = (FA.LAUNCHES["flash_attention"], calls[0],
                                time.perf_counter() - t)
        finally:
            transformer.decode_step = decode_step
            FA.flash_attention_cuda = fa
        self.launches["serve"] = {"flash_attention": sum(
            c[0] for c in counts.values())}
        # -- checks -------------------------------------------------------------
        for mode, (launches, n_calls, wall) in counts.items():
            run = runs[mode]
            if launches != cfg.num_layers * n_calls or n_calls == 0:
                raise AssertionError(
                    f"serve {mode}: flash_attention launched {launches} times "
                    f"in {n_calls} decode calls of {cfg.num_layers} layers")
            toks = [list(np.asarray(r.result)) for r in run.requests]
            if not (run.summary["all_completed"] and all(
                    len(t) == NEW and all(0 <= x < cfg.vocab_size for x in t)
                    for t in toks)):
                raise AssertionError(f"serve {mode}: {run.summary}")
            log(f"serve {mode}: {len(toks)} requests, {run.summary['new_tokens']}"
                f" new tokens in {run.summary['total_s']} s = "
                f"{run.summary['tok_per_s']} tokens/s; {n_calls} decode calls"
                f" in {wall:.2f} s = {wall / n_calls * 1e3:.2f} ms a call "
                f"(host clock, mode wall time over calls); flash_attention "
                f"launches {launches} = {cfg.num_layers} x {n_calls}")
        cont = runs["continuous"]
        for which in ("first_token", "e2e"):
            p = cont.metrics.latency_percentiles(which)
            log(f"serve continuous: arrival -> {which} p50 {p['p50']:.4f} s, "
                f"p99 {p['p99']:.4f} s")
        by_rid = sorted(cont.requests, key=lambda r: r.rid)
        prompts = [cont.corpus[r.row_start:r.row_start + r.num_rows]
                   for r in by_rid]
        oracle = sequential_oracle(cont.engine, prompts, [NEW] * len(by_rid))
        if [r.result for r in by_rid] != oracle:
            raise AssertionError("serve continuous: tokens differ from the "
                                 "sequential oracle on the same engine")
        log(f"serve continuous: {len(by_rid)} token streams bit-identical to "
            f"the sequential oracle")
        q, k, v = captured["args"]
        self._close("flash_attention", fa(q, k, v, **captured["kw"]),
                    ref.attention_ref(q, k, v, **captured["kw"]), 2e-2)
        log(f"serve: captured decode inputs q {tuple(q.shape)} k "
            f"{tuple(k.shape)} {q.dtype}: kernel within 2e-2 of the plain "
            f"version")
        # Decode replay of one prompt against the plain prefill forward, in
        # bf16 as served and in fp32, then the time of a synchronized B=1
        # decode call past the prompt (bf16).
        prompt = torch.from_numpy(prompts[0].astype(np.int32)).to(self.dev)[None]
        for dtype, tol in PREFILL_REL_TOL.items():
            m = build_model(cfg.replace(dtype=dtype))
            with torch.no_grad():
                state = m.init_decode_state(params, 1, PROMPT + NEW)
                for t in range(PROMPT):
                    logits, state = m.decode(params, state,
                                             {"tokens": prompt[:, t:t + 1]})
                pre = m.prefill_logits(params, {"tokens": prompt})
            a, b = logits.float(), pre.float()
            rel = ((a - b).norm() / b.norm()).item()
            log(f"serve: {dtype} decode-replay logits vs prefill logits: "
                f"relative L2 {rel:.3e} (bound {tol}), max abs "
                f"{(a - b).abs().max().item():.3e}, |logit| max "
                f"{b.abs().max().item():.3f}, same argmax "
                f"{bool(a.argmax() == b.argmax())}")
            if not (rel <= tol and bool(torch.isfinite(a).all())):
                raise AssertionError(f"serve: {dtype} decode replay differs "
                                     f"from prefill (relative L2 {rel})")
            if dtype != cfg.dtype:
                continue
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                for _ in range(NEW):
                    logits, state = m.decode(params, state, {"tokens": tok})
                    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            per_call = (time.perf_counter() - t) / NEW
            log(f"serve: B=1 {dtype} decode call at positions {PROMPT}-"
                f"{PROMPT + NEW - 1}: {per_call * 1e3:.2f} ms (host clock, "
                f"synchronized) = {1 / per_call:.1f} tokens/s a stream; it "
                f"reads the {4 * n_params / 1e9:.2f} GB of fp32 weights -> "
                f">= {4 * n_params / HBM_BYTES_PER_S * 1e3:.2f} ms at "
                f"3.35 TB/s")
        log(f"serve: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, runs, cont, state, logits, pre, a, b
        torch.cuda.empty_cache()

    # -- result ----------------------------------------------------------------
    def kernel_line(self):
        launches = {}
        for counts in self.launches.values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        main_key = {"reassemble_window": "reassemble_window/window",
                    "reassemble": "reassemble/main",
                    "reassemble_tokens": "reassemble_tokens/main",
                    "flash_attention": "flash_attention/decode"}
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
            sm.phase("serve", sm.serve)
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
