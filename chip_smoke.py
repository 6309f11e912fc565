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
6. resume    the supervised main path: phi4-mini at full width with 2 layers
             (a checkpoint of params, both moments and the step is 9.79
             GB), 4 whole-window steps under the train driver's
             ``make_supervisor`` (checkpoints of the reference layout,
             stacked on the host, every 2 steps into ``build/``); a node
             fault strikes inside the fourth step, after the optimizer has
             written the params in place, and the supervisor reads step 2
             through a CkIO session into the live tensors and replays
             steps 3-4. One failure, one restore, 6 window-kernel launches
             (4 steps and 2 replays), no table upload, and losses and final
             params bit-equal to an unbroken run of the same steps; save
             (host snapshot, write) and restore times, the restore
             session's bytes and readers, peak host and device memory are
             printed. Then the driver itself (``launch.train.main
             --layers 2 --resume``) resumes from that run's step-2 file:
             its two losses and the params of its step-4 file must be the
             unbroken run's, with 2 window-kernel launches. It needs about
             30 GB of disk (two 9.79 GB files and the one being written);
7. compress  one main-path step at 4 layers with each gradient compression
             ("bf16", "int8_ef"): finite loss and grad norm, the int8
             residual at most half a scale, 20 rounds of error feedback on
             the step's own grads within max |g| of 20 g (the reference's
             bound), peak device memory;
8. arrival   ``ops.device_ingest`` over arrival-ordered stagings of the
             corpus's step windows, as a CkIO session delivered them (block
             permutation and token-map layouts): the entry point that reaches
             the block and token gather kernels;
9. timing    each kernel, its plain version and, where one exists, a single
             PyTorch call for the same function, at the main-path shapes and
             at a 64 MiB window (whole, and in 4,098 chunks of 16 KiB; token
             maps random and arrival-ordered), beside the bytes bound (3.35
             TB/s) and, for token maps, the 32-byte-sector floor;
10. attention the flash-attention kernel against its plain version on the
             card (fp32 at 1e-5, bf16 at 2e-2): the six sweep cases of
             tests/test_kernels.py, phi4-mini decode shapes (Sq=1, H=24,
             K=8, hd=128, Sk in 1/17/129/2048) and a 2048-token causal
             prefill, recurrentgemma's (Sq=1, H=10, K=1, hd=256, Sk in
             1/17/129/2048, the last a full ring with no window) and a
             2048-token causal prefill with window 2048; then its time, the
             plain version's and ``scaled_dot_product_attention``'s at the
             served decode shapes and at the prefill shapes, beside the
             bound; then the decode shapes of the five families of phases
             16-20 (hd 128: 32/32, 40/10 and 16/16 heads at Sk 1 to 2048,
             gemma3's 32/16 with its window of 1,024 while a ring fills,
             over a full 1,024-slot ring and over a 1,100-key global
             prefix), at B=1 and B=4, decode rows bit-identical at B=1 and
             B=4 there too, and the time of each served shape beside SDPA's;
             then the shapes of phases 25-26 (NEW_SHAPES), at B=1 and B=4:
             qwen2-vl decode (Sq=1, H=12, K=2, hd=128, Sk 1/17/129/2048),
             whisper's self-attention decode (H=K=16, hd=64, Sk
             1/17/129/448), its cross-attention (Sq=1 over 1,500 keys, no
             mask) and its encoder (Sq=Sk=1,500, no mask: 1,500 rows are
             not a multiple of the tensor-core path's 64-row blocks), decode
             rows bit-identical at B=1 and B=4, and the served shapes timed
             beside the plain version, SDPA and the bound; then the decode
             kernel's logit softcap at caps 30 and 50 (decode shapes of
             phi4-mini and recurrentgemma, span edges, a full ring at B=4,
             windows; q scaled by 4 in fp32 and 16 in bf16 so that the
             scores bend) against the plain version;
11. scan     the literal selective-scan kernel against its plain version
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
12. lru      the same for the RG-LRU: the literal kernel (1e-5) over the
             three sweep cases, a ragged case (B=3, S=37, W=50),
             recurrentgemma's decode shape (B=1, S=1, W=2560) from a random
             h0, a 2100-token prefill and the bound's shape (B=8, S=2048,
             W=2560); then the gated entry (gates, recurrence and output
             product; y at 1e-5 in fp32 and 2e-2 in bf16, h_S at 1e-5) at
             the sweep and ragged shapes, decode from h0 in bf16 and fp32,
             the 2100-token prefill and B=8, S=2048, with xr channel-major
             as the conv leaves it (no PyTorch call computes the
             recurrence);
13. serve    the second main path, ``repro_torch.launch.serve``: phi4-mini
             at full width with all 32 layers, random weights from seed 0,
             bf16 compute; static mode (BatchServer over one CkIO bulk read,
             4 requests, batch 4) and continuous mode (a 3-shard FileSet,
             3 requests, 4 slots, Poisson arrivals), 128 prompt tokens and
             16 new tokens a request. Every decode call runs the attention
             of each of the 32 layers through the kernel; continuous tokens
             must equal the sequential oracle's on the same engine, and
             replaying a prompt through decode must give the logits of the
             plain prefill forward;
14. serve_ssm the third main path: the same for falcon-mamba-7b at full
             width with all 64 layers (static: 4 requests, batch 4;
             continuous: 2 requests, 4 slots), 64 prompt tokens and 16 new
             ones a request. Every decode call runs each of the 64 layers'
             discretization, scan and epilogue through the fused kernel
             (S=1 from the carried state), one launch a layer; the prefill
             forward (ssm_impl "materialized") runs the literal kernel once
             a layer over the prompt;
15. serve_hybrid the fourth main path: the same for recurrentgemma-2b at
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
16-20. serve_codeqwen, serve_phi3, serve_gemma3, serve_qwen2moe,
             serve_olmoe: the same two modes for codeqwen1.5-7b (32 layers,
             MHA 32/32, QKV bias), phi3-medium-14b (40 layers, GQA 40/10),
             gemma3-27b (all 62 layers, 5 local layers with 1,024-key
             windows to 1 global; bf16 params, 54 GB, since its 108 GB of
             fp32 ones exceed the card), qwen2-moe-a2.7b (24 MoE layers: 60
             routed experts top-4 + 4 padded ones, 4 shared experts) and
             olmoe-1b-7b (16 MoE layers, 64 experts top-8), all at full
             width with random weights from seed 0, fp32 params but
             gemma3's; 64 prompt tokens and 16 new ones a request (static:
             4 requests, batch 4; continuous: 2 requests, 4 slots). Every
             layer is attention, so each decode call launches the kernel
             once a layer; the MoE FFNs are PyTorch einsums, as the
             reference computes them outside any Pallas kernel. Each phase
             holds a captured served decode input against the plain
             version, continuous tokens against the oracle, the decode
             replay against the prefill forward, and peak memory under 80
             GB; serve_gemma3 then runs its first 6 layers (5 local + 1
             global) in fp32 over a 1,100-token prompt, so the local rings
             wrap while the global layer keeps every position (1e-4);
21. fileset  the train driver over a 3-shard corpus through the cold-path
             read engine, in three legs. (a) ``launch.train.main`` with
             phi4-mini at full width, 4 layers, batch 8 x 2048, 4
             microbatches, 4 steps, ``--device-ingest --direct-io
             --queue-depth 8 --num-readers 4 --data a b c``, whole-window
             and then ``--streaming``: the corpus holds 2 step windows
             (steps 3-4 read windows 1-2 again, the driver's ``step %
             num_steps``), each straddling a shard start (interior shards
             of whole blocks, the last odd-sized). Batches and the 4 losses
             must be bit-equal to a single file of the same tokens read
             with the blocking buffered loop; one window-kernel launch a
             step, no table upload; every session's in-flight high-water
             mark <= 8; per-shard bytes summing to the bytes read; no read
             spanning two shard files. Checkpoints are off in these runs
             (each would save 12.2 GB twice; phase 6 holds them). (b) One
             cold session of 2 GiB over 3 shard files, blocking buffered,
             queue depth 8 buffered with 8 MiB of readahead, and queue
             depth 8 ``O_DIRECT``: the files evicted (``drop_page_cache``)
             and the eviction checked with ``mincore`` before each; bytes
             exact; GB/s beside the cache state, the submit kind and the
             filesystem under ``build/``. (c) 8 cold sessions of 256 MiB
             of one shard file under ``adaptive_queue`` and then under
             ``adaptive_splinters``: the (depth, readahead) and splinter
             paths the tuners chose, each session's GB/s, bytes exact.
             Where no ``O_DIRECT`` open succeeds under ``build/``, (a)
             asserts that ``--direct-io`` raises ``DirectIOError`` naming
             the file and runs buffered at queue depth 8, and (b) drops its
             direct mode. These are host-storage numbers on the card's
             machine, not a speed of the card;
22. process  the driver of phase 21 (a) over the same 3 shards and flags
             with ``--backend process --max-workers 4``: every step
             session's arena is a shared-memory segment that 4 reader
             worker processes fill (each rebuilds its own shard fds and
             drains at queue depth 8), whole-window and streamed. Batches
             and the 4 losses must be bit-equal to phase 21's thread-
             backend runs; one window-kernel launch a step, no table
             upload; worker processes (4, none this process) served every
             session that read bytes, none degraded; the workers' in-flight
             high-water mark <= 8. It prints the workers' submit kind,
             direct tails, spawn -> attached ms a session, and
             ``get_batch_device`` ms a step with its share of the step.
             Then a ``CkIOPipeline`` over the shards (``O_DIRECT`` where it
             runs, blocking worker reads, 3-block splinters: 2 a reader)
             with a seeded ``FaultPlan`` that crashes one worker of every
             session after its first splinter: under ``recovery="respawn"``
             each session respawns once, under ``"reissue"`` re-reads the
             tail here, both with batches bit-equal to the unbroken run;
             under ``"none"`` ``get_batch_device`` raises ``WorkerCrashed``
             at once and the pipeline closes;
23. service  the driver of phase 22 with ``--service --pool-workers 4
             --max-workers 4`` instead: every step session runs on a
             persistent pool of 4 reader workers (fresh interpreters started
             once, re-armed per session through shared-memory mailboxes)
             over arenas recycled from a pool, whole-window and streamed.
             Batches and the 4 losses must be bit-equal to phase 21's
             thread-backend runs; one window-kernel launch a step, no table
             upload; every session that read bytes pooled with 4 workers,
             none evicted or failed. It prints each session's epoch,
             checkout (submit -> all attached) and arena hit or miss beside
             phase 22's spawn -> attached, and ``get_batch_device`` with its
             share of each step; a re-armed session's checkout must be at
             least 5x below phase 22's fastest spawn -> attached. Then
             phi4-mini at full width with 4 of its 32 layers (phase 13
             serves all 32; this run's subject is the pool, so its depth is
             cut to keep the script's time), weights from seed 0, served
             ``--continuous --service --pool-workers 2 --layers 4`` (3
             requests): tokens equal to the
             sequential oracle's, every request's session pooled, one
             flash-attention launch a layer a decode call. Then phase 22's
             fault pipeline on a pool of 4: ``respawn`` (the tail re-armed
             on another pool worker) and ``reissue`` bit-equal; under
             ``"none"`` the crashed session fails alone while a sibling
             session on the same pool completes bit-equal, one worker is
             evicted, and the next session runs. After every shutdown no
             ``ckiot-`` name of this process is left in ``/dev/shm``;
24. numa     the host's NUMA nodes (``/sys/devices/system/node``) and the
             card's PCI ``numa_node``; then the driver with ``--topology
             auto --numa-pin`` under ``--placement domain_spread`` and
             ``near_consumers``, on the thread and the process backend
             (whole-window), each bit-equal (batches and losses) to phase
             21's plain run, with the ``locality`` summary (pinned threads
             or workers, pin failures, same- and cross-domain bytes,
             first-touched pages against arena pages). On a host of one
             domain this checks the plumbing only;
25. serve_vlm qwen2-vl-2b at full width and depth (28 layers, d_model
             1,536, 12/2 heads at hd 128, M-RoPE sections (16, 24, 24)),
             random fp32 weights from seed 0, bf16 compute, served through
             the library, since the serve driver refuses the arch as the
             reference's does: ``BatchServer`` over one CkIO bulk read (4
             requests, batch 4) and a ``ContinuousBatcher`` over a
             ``RequestIngester`` on a 3-shard ``FileSet`` (3 requests, 4
             slots), 64 prompt and 16 new tokens a request; continuous
             tokens equal to the sequential oracle's on the same engine, 28
             flash-attention launches a decode call. A prefill forward of 64
             patch embeddings at distinct (t, h, w) positions gives finite
             logits; the embeddings replayed through decode (positions
             broadcast) give the prefill forward's logits, bf16 and fp32;
             then a token replay, B=1 decode calls timed and 8 profiled
             (device time, busy share);
26. serve_audio whisper-medium at full width and depth (24 encoder and 24
             decoder layers, d_model 1,024, 16/16 heads at hd 64), the
             same weights and compute: 1,500 x 1,024 frames written by
             ``make_embedding_file`` and read onto the card through one CkIO
             session; ``greedy_generate(frames=)`` for 4 requests at B=4
             and a ``ModelEngine(frames=)`` behind a ``ContinuousBatcher``
             (3 requests, 4 slots), tokens equal to the oracle's. Each
             decode call launches the kernel 48 times (24 self-attention
             over the ring, 24 cross-attention over the 1,500 frames), each
             admission 24 times (the encoder, on the tensor-core path, as
             ``launch_plan`` reports). The decode replay gives
             ``forward_logits``' last logits (plain attention), bf16 and
             fp32; an admission is timed, B=1 decode calls timed and 8
             profiled;
27. sharded  the constructor-sharded pipeline, on a world-size-1 process
             group over the card (nccl; gloo if nccl refuses) and a
             ``("data",)`` ``DeviceMesh``: (a) the main path of phases 4-5
             (phi4-mini at full width, 4 layers, B=8 x 2048, 4
             microbatches, 4 steps) from a pipeline built with
             ``sharding=NamedSharding(mesh, P("data", None))``, whole-window
             and streamed: each batch's ``to_local()`` and the 4 losses
             bit-equal to phase 4's, ``ShardMetrics`` exact (window bytes =
             addressable bytes, 0 cross-host; 4 copies whole-window, more
             streamed), 4 window-kernel launches a mode, ``get_batch_device``
             and its share of the step beside phases 4-5's; (b) two ranks on
             the one card: two processes of this script
             (``--sharded-rank``), a gloo group over a ``FileStore``, each
             reading the corpus's first 2 windows whole-window and streamed:
             each stages its 4-row block alone and counts the other's bytes
             cross-host, and the two blocks tile phase 4's batches; (c)
             ``ops.ingest_chunks_block`` and ``ops.ingest_chunks_tokens``
             over the arrival-ordered splinters of a real session (16 KiB
             splinters, one chunk each), bit-equal to their plain versions
             and to ``ops.reassemble_window`` of the file-order window; (d)
             the phase's params saved and restored by ``restore_sharded``
             onto ``param_specs`` over the 1-rank mesh, every leaf's local
             block bit-equal to ``restore_tree``'s, its placements the
             spec's. The group is destroyed before ``dryrun``;
28. examples ``examples/torch_serve_lm.py`` at its preset (reduced
             recurrentgemma, 12 requests, batch 4) on the card, in this
             process: the gated RG-LRU and flash-attention kernels run;
29. dryrun   ``repro_torch.launch.dryrun.run_cell`` on the 1-card host
             mesh at phase 4's train configuration (phi4-mini, 4 layers,
             B = 8 x 2048, 4 microbatches) and at phase 13's B=1 phi4-mini
             decode call (32 layers, a 144-slot cache, position 143), on
             the meta device; then that train step and that decode call on
             the card under the dry run's ``FlopCounterMode``. The meta
             count must equal the card's aten count plus the registered
             formula (``kernels/meta.py``) of every kernel the card
             launched through ctypes, which aten does not see (the decode
             call's 32 flash-attention launches; the train step's
             attention entries at the dense products of the ``_sdpa`` that
             the meta pass runs in their place); the predicted per-device
             argument + temp bytes must be within 25 % of the step's
             ``torch.cuda.max_memory_allocated``. The measured step and
             call times are printed against the roofline's ``step_s``
             (``launch/roofline.py``, H100 constants) as a share, beside
             the card's name and power limit. Then the train steps of
             phases 31-32 (falcon-mamba at 4 layers in each ``ssm_impl``,
             recurrentgemma at 6), each predicted argument + temp within
             25 % of its ``max_memory_allocated``;
30. profile  only with ``--profile``, last: two whole-window main-path
             steps, 16 B=1 decode calls of phi4-mini and 8 each of
             falcon-mamba and recurrentgemma under ``torch.profiler``
             (device busy share, kernels and copies a call, kernels by
             device time);
31. train_ssm falcon-mamba-7b trained on the card. The literal and fused
             selective-scan backward kernels against their plain backwards
             (``kernels/ref.py``): fp32 at 1e-4 elementwise, bf16 at 2e-2 of
             each gradient's largest magnitude, S = 1, 17 and 2048 with and
             without h0, ``z`` and ``proj`` strided views, ragged D and odd
             r, the fused backward's chunk edges (S = 63, 64, 65, 157; B=2,
             D past one block), the literal one's cluster plan edges (a
             chunk less one and one more at S=2048, windows at S = 4096,
             4097 and 8193, every state size), and a microbatch of
             the train step (B=2,
             S=2048, D=8192, N=16; bf16 with channel-major xin for the
             fused one); each twice on the same inputs for the same bits,
             timed at the microbatch beside its plain version and its
             bound, with the device time of its kernels alone. Then
             ``launch.train.main`` at full width with 4 of the 64 layers,
             batch 8 x 2048, 4 microbatches, 4 steps, checkpoints off, once
             in each ``ssm_impl``: finite losses, one backward-kernel launch
             a Mamba layer a microbatch (64), the forward kernel twice as
             often (the activation checkpoint recomputes it), no call into
             ``kernels/ref.py``; step time (host clock around a
             synchronized step), tokens/s, peak device memory, and the
             backward kernels' share of the third step's device time under
             ``torch.profiler``;
32. train_hybrid the same for recurrentgemma-2b: the gated RG-LRU backward
             kernel (fp32 at 1e-5, bf16 at 2e-2 of scale; its chunk and
             segment edges S = 7, 8, 9, 128, 129, 293 at B=2; B=2, S=2048,
             W=2560 at the microbatch, xr channel-major, ``gate`` a view),
             then the driver at 6 of its 26 layers (two (RG-LRU, RG-LRU,
             local) blocks): 64 backward launches, no flash-attention launch
             (the loss differentiates the plain attention);
33. layer_kinds a smoke-width model (d_model 64) holding all twelve
             (mixer, FFN) kinds, attention logits capped at 30, fp32: one
             train step on the card against the same step on the CPU
             (params within 1e-4 relative L2; three launches of each of the
             literal Mamba and gated RG-LRU backward kernels), then a
             24-token replay through decode (16-slot local rings wrapped,
             the capped split-key decode kernel on every attention layer)
             against its prefill forward at capacity factor E/k (1e-4
             relative L2).

Phases 31-33 run after ``dryrun`` and before ``profile``.

The launch counts are zeroed just before each main-path run (phases 4-8,
each mode of phases 13-20, the prefill forwards of phase 14's replay check,
the two ring-wrap replays, the three driver runs of phase 21, each driver
run and fault pipeline of phase 22, each driver run, the serving run and
each fault pipeline of phase 23, each driver run of phase 24, and each mode
and replay of phases 25-26, each mode of phase 27 (a), each rank and mode
of (b) in its own process, (c) and the example of phase 28, and each
driver run of phases 31-32) and read just after it. The line before the last is a JSON object with one entry per kernel;
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
    "mamba_scan_backward": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
    "mamba_scan_fused_backward": "src/repro_torch/kernels/csrc/mamba_scan.cu",
    "rglru_scan_gated_backward": "src/repro_torch/kernels/csrc/rglru_scan.cu",
    "flash_attention_train": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_backward":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
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
    # No TPU kernel has a backward: the reference differentiates these
    # functions with XLA's autodiff.
    "mamba_scan_backward": "none: XLA's autodiff of "
                           "src/repro/models/ssm.py:61 (_chunked_scan)",
    "mamba_scan_fused_backward": "none: XLA's autodiff of "
                                 "src/repro/models/ssm.py:95 "
                                 "(_fused_chunk_scan) and the skip and gate "
                                 "of ssm.py:180-181",
    "rglru_scan_gated_backward": "none: XLA's autodiff of "
                                 "src/repro/models/rglru.py:52 (_gates) and "
                                 "the associative scan of rglru.py:88",
    "flash_attention_train": "none: the forward of XLA's autodiff of "
                             "src/repro/models/attention.py (_sdpa), with "
                             "the log-sum-exp its backward reads",
    "flash_attention_backward": "none: XLA's autodiff of "
                                "src/repro/models/attention.py (_sdpa)",
}
BWD_KERNELS = ("mamba_scan_backward", "mamba_scan_fused_backward",
               "rglru_scan_gated_backward")
# The training attention's two entries (the forward with its log-sum-exp,
# the backward), timed at phi4-mini's microbatch.
ATTN_TRAIN = ("flash_attention_train", "flash_attention_backward")
# The device kernels the three backward entries launch (profiler names).
BWD_DEVICE_KERNELS = ("scan_bwd_cluster_kernel", "fused_bwd_sum_kernel",
                      "fused_bwd_carry_kernel", "fused_bwd_kernel",
                      "proj_grad_kernel", "lru_bwd_kernel",
                      "ordered_sum_kernel")
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
# The supervised run: layers (a checkpoint of params, both moments and the
# step is 9.79 GB at 2 layers, 12.2 GB at 4), checkpoint interval, and the
# step index inside which the injected fault strikes.
RESUME_LAYERS, RESUME_EVERY, RESUME_FAULT = 2, 2, 3
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
# The five text families served since: arch -> (the smoke phase, its param
# dtype). gemma3-27b's 27.0 B params
# take 108 GB in fp32, past one 80 GB card, so it is served with bf16 params
# (54 GB) at all 62 layers; the others in fp32 at all their layers. Each
# serves FAM_PROMPT-token prompts (FAM_STATIC_REQUESTS static, batch 4;
# FAM_CONT_REQUESTS continuous, 4 slots) with NEW new tokens.
FAMILIES = {
    "codeqwen1.5-7b": ("serve_codeqwen", "float32"),
    "phi3-medium-14b": ("serve_phi3", "float32"),
    "gemma3-27b": ("serve_gemma3", "bfloat16"),
    "qwen2-moe-a2.7b": ("serve_qwen2moe", "float32"),
    "olmoe-1b-7b": ("serve_olmoe", "float32"),
}
FAM_PROMPT, FAM_STATIC_REQUESTS, FAM_CONT_REQUESTS = 64, 4, 2
# The fileset phase: queue depth of leg (a) and (b); leg (b)'s shards in
# MiB (the last one 517 tokens past it: odd-sized); leg (c)'s sessions.
FS_DEPTH, FS_READERS = 8, 4
COLD_SHARD_MIB, COLD_READAHEAD = (720, 720, 608), 8 << 20
TUNER_SESSIONS, TUNER_BYTES = 8, 256 << 20
# The process and numa phases: worker processes a session; the seed of the
# crash that the fault leg injects, and its watchdog.
PROC_WORKERS, FAULT_SEED, FAULT_WATCHDOG_S = 4, 20261017, 30.0
# gemma3's ring-wrap check: its first block (5 local layers with 1,024-slot
# rings, 1 global layer) at full width in fp32, one prompt past the window.
G3_WINDOW, G3_WRAP_LAYERS, G3_WRAP_PROMPT = 1024, 6, 1100
# Their decode shapes (H, K, Sk, window) at hd 128, held in the attention
# phase: key counts at the 32-key spans' edges, the served prefix and a
# long one; gemma3's window while a local ring fills, its full ring (no
# window) and a global prefix past the window.
FAMILY_DECODE = [
    *[(h, k, sk, 0) for h, k in ((32, 32), (40, 10), (16, 16))
      for sk in (1, 63, 64, 65, FAM_PROMPT + NEW, 2048)],
    *[(32, 16, sk, G3_WINDOW) for sk in (1, 65, FAM_PROMPT + NEW, 1023,
                                         G3_WINDOW)],
    (32, 16, G3_WINDOW, 0), (32, 16, G3_WRAP_PROMPT, 0),
]
# The last two families, served through the library (the serve driver
# refuses them, as the reference's does): qwen2-vl-2b (28 layers, 12/2
# heads at hd 128, M-RoPE) and whisper-medium (24 encoder and 24 decoder
# layers, 16/16 heads at hd 64, 1,500 frames of d 1,024), fp32 params,
# bf16 compute, FAM_PROMPT-token prompts and NEW new tokens (static: 4
# requests at batch 4; continuous: 3 requests on 4 slots).
VLM_H, VLM_KV, VLM_HD, VLM_LAYERS = 12, 2, 128, 28
AUD_H, AUD_HD, AUD_LAYERS, AUD_FRAMES = 16, 64, 24, 1500
LIB_STATIC_REQUESTS, LIB_CONT_REQUESTS = 4, 3
# Their attention shapes (B, H, K, Sq, Sk, hd, causal): decode at the
# 32/64-key spans' edges and past them, whisper's self-attention up to its
# 448-token cap, its cross-attention over the 1,500 frames (the last of 24
# splits holds 28 keys) and its encoder (1,500 rows: not a multiple of the
# tensor-core path's 64-row blocks).
NEW_SHAPES = [
    *[(b, VLM_H, VLM_KV, 1, sk, VLM_HD, True) for b in (1, 4)
      for sk in (1, 17, 129, 2048)],
    *[(b, AUD_H, AUD_H, 1, sk, AUD_HD, True) for b in (1, 4)
      for sk in (1, 17, 129, 448)],
    *[(b, AUD_H, AUD_H, 1, AUD_FRAMES, AUD_HD, False) for b in (1, 4)],
    *[(b, AUD_H, AUD_H, AUD_FRAMES, AUD_FRAMES, AUD_HD, False)
      for b in (1, 4)],
]
# The sharded phase's two-rank check: steps each rank reads a mode.
RANK_STEPS = 2
# Logits of a prompt replayed through decode (kernel attention) against the
# plain prefill forward: relative L2 bound by compute dtype. In bf16 each
# path is ~2e-2 from the fp32 logits after 32 layers (a CPU run of
# d_model 768 put both, and their difference, at 1.9e-2), so the bound is
# 5e-2; in fp32 the two differ by summation order only.
PREFILL_REL_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# The SSM and hybrid train steps (train_ssm, train_hybrid): falcon-mamba at
# 4 of its 64 layers (0.95 B params: params, grads and both moments take
# 15 GB) and recurrentgemma at 6 of its 26 (two (RG-LRU, RG-LRU, local)
# blocks, 1.17 B params), both at the window phase's batch of 8 x 2048 in 4
# microbatches; the backward kernels are held at a microbatch's shape.
SSM_TRAIN_LAYERS, HYB_TRAIN_LAYERS = 4, 6
MB = B // MICROBATCHES
# The layer_kinds phase: a smoke-width model of all twelve (mixer, FFN)
# kinds with a capped attention logit, a 40-token batch and a 24-token
# replay (past its 16-slot local rings); its card step is held to the CPU's
# at this relative L2 (fp32: another summation order on each side).
KINDS_CAP, KINDS_SEQ, KINDS_REPLAY, KINDS_PARAM_TOL = 30.0, 40, 24, 1e-4


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


def kernels_alone_ms(fn, names=BWD_DEVICE_KERNELS, calls: int = 3):
    """The device time of one ``fn()`` in the kernels named by ``names``,
    and by kernel: ``torch.profiler`` over ``calls`` calls, after a warm-up
    step of as many that lets its tracing start. None (with what was seen)
    where a kernel's count is not a multiple of ``calls``: events lost."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = []   # the active step's events, kept as its cycle ends
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: seen.extend(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by_name, counts = {}, {}
    for e in seen:
        hit = [k for k in names if re.search(rf"\b{k}\b", e.key)]
        if e.device_type == DeviceType.CUDA and hit:
            by_name[hit[0]] = (by_name.get(hit[0], 0.0)
                               + e.self_device_time_total / (1e3 * calls))
            counts[hit[0]] = counts.get(hit[0], 0) + e.count
    if not by_name or any(c % calls for c in counts.values()):
        return None, by_name
    return sum(by_name.values()), by_name


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
    n = b * (s + 1)
    pieces = [(4 * o, 4 * min(splinter_tokens, n - o))
              for o in range(0, n, splinter_tokens)]
    pieces = [pieces[i] for i in rng.permutation(len(pieces))]
    return pieces_row_idx(pieces, 0, b, s)


def pieces_row_idx(pieces, off: int, b: int, s: int):
    """The token map (``(b, s+1)`` int32) of int32 ``pieces`` (``(byte
    offset, bytes)``, in staged order) of a window at byte ``off``."""
    import numpy as np

    from repro_torch.data.packing import row_gather_index, token_gather_from_pieces

    g = token_gather_from_pieces(pieces, off, 4)
    return np.ascontiguousarray(row_gather_index(g, global_batch=b, seq_len=s))


def tokens_sector_floor_bytes(row_idx) -> int:
    """Bytes a token gather moves when each gathered 4-byte token costs a
    32-byte sector (a random map): the index rows, one sector per gathered
    (row, column) entry, the two outputs. A floor for a random map, not
    the bound (which counts each distinct token once)."""
    b, s1 = row_idx.shape
    return 4 * row_idx.numel() + 32 * int((row_idx >= 0).sum()) + 8 * b * (s1 - 1)


# -- page-cache residency (a copy of benchmarks/common.py's probe) -------------
def residency(path: str):
    """Fraction of ``path``'s pages resident in the page cache, or ``None``
    when mincore isn't usable (non-Linux libc, empty file, sandbox)."""
    import ctypes
    import ctypes.util
    import mmap

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        libc.mincore  # AttributeError if the symbol is missing
    except (OSError, AttributeError):
        return None
    try:
        size = os.path.getsize(path)
        if size <= 0:
            return None
        npages = (size + mmap.PAGESIZE - 1) // mmap.PAGESIZE
        fd = os.open(path, os.O_RDONLY)
        try:
            # MAP_PRIVATE + PROT_WRITE: ctypes.from_buffer needs a writable
            # buffer; private COW keeps the file itself untouched.
            m = mmap.mmap(fd, size, flags=mmap.MAP_PRIVATE,
                          prot=mmap.PROT_READ | mmap.PROT_WRITE)
        finally:
            os.close(fd)
        try:
            vec = (ctypes.c_ubyte * npages)()
            addr = ctypes.addressof(ctypes.c_char.from_buffer(m))
            if libc.mincore(ctypes.c_void_p(addr), ctypes.c_size_t(size),
                            vec) != 0:
                return None
            return sum(b & 1 for b in vec) / npages
        finally:
            del vec
            m.close()
    except (OSError, ValueError):
        return None


def evict(paths):
    """Drop ``paths`` from the page cache and say how far that is known:
    "verified" (fadvise worked and mincore shows at most 2 % of each file's
    pages resident), "advisory" (fadvise worked, mincore unavailable) or
    "warm" (eviction failed or did not hold); with each file's fadvise
    result and resident share after it."""
    from repro_torch.io.posix import drop_page_cache

    states, detail = [], []
    for p in paths:
        dropped = drop_page_cache(p)
        frac = residency(p)
        detail.append(f"{os.path.basename(p)}: fadvise "
                      f"{'ok' if dropped else 'failed'}, resident "
                      f"{'unknown' if frac is None else f'{frac:.4f}'}")
        states.append("warm" if not dropped else "advisory" if frac is None
                      else "verified" if frac <= 0.02 else "warm")
    state = next((s for s in ("warm", "advisory") if s in states),
                 "verified")
    return state, "; ".join(detail)


def fs_type(path: str) -> str:
    """The filesystem type ``/proc/mounts`` gives for ``path``'s mount."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, typ = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, kind = mnt, typ
    return f"{kind} at {best}"


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
                    "mamba_scan_fused": 0, "rglru_scan_gated": 0,
                    "flash_attention_train_rows": 0,
                    **{k: 0 for k in BWD_KERNELS + ATTN_TRAIN}}
        self.launches = {}
        self.main_inputs = {}      # kernel -> args captured from the main path
        self.timing = {}
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
        self.batches = {}
        self.losses = {}
        self.ingest_time = {}      # mode -> (get_batch_device s, step s)

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

    def _trainer(self, layers: int = ARCH_LAYERS, compression=None):
        """The main path's model, state and step: phi4-mini at full width
        with ``layers`` layers, random weights from seed 0."""
        from repro_torch.models import build_model
        from repro_torch.train import OptConfig, init_opt_state, make_train_step

        cfg, path = self._corpus()
        cfg = cfg.replace(num_layers=layers)
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        step_fn = make_train_step(
            model, OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=STEPS),
            num_microbatches=MICROBATCHES, compression=compression)
        return cfg, path, model, params, init_opt_state(params), step_fn

    def _pipeline(self, path, streaming: bool, sharding=None):
        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data import CkIOPipeline

        return CkIOPipeline(
            path, B, S, ckio=CkIO(num_pes=4, pes_per_node=4),
            num_consumers=16, file_opts=FileOptions(num_readers=4),
            streaming=streaming, sharding=sharding, device=self.dev)

    def main_path(self, streaming: bool):
        import numpy as np
        import torch

        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import reassemble as K
        from repro_torch.models import build_model

        cfg, path, model, params, opt, step_fn = self._trainer()
        raw = np.fromfile(path, dtype=np.uint32, offset=4096).view(np.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mode = "streamed" if streaming else "window"
        # Capture the window kernel's main-path inputs for phase 9.
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
        FA.reset_launch_counts()
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
        counts = {**K.LAUNCHES, **{k: FA.LAUNCHES[k] for k in ATTN_TRAIN}}
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
        # Attention trains through the kernels: a forward and a recompute a
        # layer a microbatch, and one backward.
        calls = cfg.num_layers * MICROBATCHES * STEPS
        if (counts["flash_attention_train"], counts["flash_attention_backward"]
                ) != (2 * calls, calls):
            raise AssertionError(f"{mode}: attention launches {counts}, "
                                 f"{2 * calls} and {calls} expected")
        if uploads != 0:
            raise AssertionError(f"{mode}: the window wrapper uploaded "
                                 f"{uploads} chunk tables (0 expected: the "
                                 f"main path's tables go by value)")
        self.batches[mode] = batches
        self.losses[mode] = losses
        steady = t_steps[1:] or t_steps
        step_s = sum(steady) / len(steady)
        ingest_s = sum(t_ingest[1:] or t_ingest) / len(steady)
        self.ingest_time[mode] = (ingest_s, step_s)
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

    # -- 6, 7 ------------------------------------------------------------------
    def _unbroken(self):
        """``STEPS`` whole-window steps of the ``RESUME_LAYERS``-layer model
        in a plain loop: the losses, the final params on the host and the
        peak device memory."""
        import torch

        from repro_torch.train import leaves

        _, path, _, params, opt, step_fn = self._trainer(RESUME_LAYERS)
        pipe = self._pipeline(path, streaming=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        try:
            for step in range(STEPS):
                x, y = pipe.get_batch_device(step)
                params, opt, m = step_fn(params, opt, {"tokens": x, "labels": y})
                losses.append(float(m["loss"]))
        finally:
            pipe.close()
        final = [t.cpu() for t in leaves(params)]
        peak = torch.cuda.max_memory_allocated()
        del params, opt
        torch.cuda.empty_cache()
        return losses, final, peak

    def resume(self):
        """The supervised main path: ``STEPS`` steps of the
        ``RESUME_LAYERS``-layer model under the driver's
        ``make_supervisor``, checkpoints every ``RESUME_EVERY`` steps, and
        a node fault inside step index ``RESUME_FAULT`` after the optimizer
        has written the params in place. The restore reads the step-2 file
        through a CkIO session into the live tensors and replays steps
        2-3; the losses and final params must have the bits of an unbroken
        run. Then the driver's own ``--resume`` from the step-2 file."""
        import resource

        import torch

        from repro_torch.kernels import reassemble as K
        from repro_torch.launch.train import make_supervisor
        from repro_torch.train import FaultInjected, leaves
        from repro_torch.train import checkpoint as CK

        ckdir = os.path.join(self.tmp, "ckpts")
        free = shutil.disk_usage(self.tmp).free
        log(f"resume: {free / 1e9:.1f} GB free under the checkout's build/")
        want_losses, want_params, plain_peak = self._unbroken()
        cfg, path, _, params, opt, step_fn = self._trainer(RESUME_LAYERS)
        pipe = self._pipeline(path, streaming=False)
        live = [t.data_ptr() for t in leaves(params)]
        left = [1]

        def supervised_step(state, batch):
            p, o, m = step_fn(state["params"], state["opt"], batch)
            if left[0] and o["step"] == RESUME_FAULT + 1:
                left[0] = 0
                raise FaultInjected("node died after the optimizer wrote "
                                    f"step {o['step']} in place")
            return {"params": p, "opt": o}, m

        sup = make_supervisor(supervised_step, cfg, ckdir,
                              ckpt_every=RESUME_EVERY, keep=2)
        ck = sup.ckpt
        reads = []
        restore_arrays = CK.restore_arrays

        def recorded(*a, **kw):
            out = restore_arrays(*a, **kw)
            reads.append(out[1]["read"])
            return out

        losses = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        K.reset_launch_counts()
        CK.restore_arrays = recorded
        t0 = time.perf_counter()
        try:
            state = sup.run(
                {"params": params, "opt": opt},
                lambda step: dict(zip(("tokens", "labels"),
                                      pipe.get_batch_device(step))),
                STEPS, on_metrics=lambda step, m: losses.setdefault(
                    step, []).append(float(m["loss"])))
        finally:
            CK.restore_arrays = restore_arrays
            ck.shutdown()
            pipe.close()
        wall = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        uploads = K.TABLE_UPLOADS
        self.launches["resume"] = counts
        peak = torch.cuda.max_memory_allocated()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        in_place = [t.data_ptr() for t in leaves(state["params"])] == live
        got_params = [t.cpu() for t in leaves(state["params"])]
        del params, opt, state
        torch.cuda.empty_cache()
        st = sup.stats
        log(f"resume: {RESUME_LAYERS} layers, {STEPS} steps in {wall:.2f} s "
            f"(host clock); failures {st.failures}, restores {st.restores}, "
            f"steps run {st.steps_run}, stragglers {st.straggler_steps}; "
            f"launches {json.dumps(counts)}, chunk-table uploads {uploads}")
        for r in ck.records:
            log(f"resume: save step {r['step']}: {r['bytes']} B, host snapshot "
                f"{r['snapshot_s']:.3f} s ({r['bytes'] / r['snapshot_s'] / 1e9:.2f}"
                f" GB/s), write {r['write_s']:.3f} s "
                f"({r['bytes'] / r['write_s'] / 1e9:.2f} GB/s, fsync included); "
                f"{self.card_line}")
        for r, t in zip(reads, st.restore_times):
            log(f"resume: restore {r['bytes']} B through a CkIO session of "
                f"{r['readers']} readers in {r['seconds']:.3f} s "
                f"({r['bytes'] / r['seconds'] / 1e9:.2f} GB/s); the whole "
                f"restore to the device {t:.3f} s; {self.card_line}")
        log(f"resume: max_memory_allocated {peak / 2**30:.2f} GiB (the "
            f"unbroken plain loop's {plain_peak / 2**30:.2f} GiB); peak host "
            f"RSS {rss / 2**20:.2f} GiB (before the phase {rss0 / 2**20:.2f} "
            f"GiB); {self.card_line}")
        # -- checks -------------------------------------------------------------
        if (st.failures, st.restores, st.reader_failures) != (1, 1, 0):
            raise AssertionError(f"resume: stats {st}")
        if not in_place:
            raise AssertionError("resume: the restore did not write the "
                                 "live params in place")
        if st.steps_run != STEPS + 1 or len(reads) != 1:
            raise AssertionError(f"resume: {st.steps_run} steps run, "
                                 f"{len(reads)} restores read")
        # steps 1-2 ran once; 3 and 4 (indices 2-3) ran again after the
        # restore of step 2, step 4's first run ending in the fault
        if counts["reassemble_window"] != STEPS + 2 or uploads != 0:
            raise AssertionError(f"resume: window launches {counts}, "
                                 f"uploads {uploads} (want {STEPS + 2}, 0)")
        want = {i + 1: [v] * (2 if i + 1 == RESUME_FAULT else 1)
                for i, v in enumerate(want_losses)}
        if losses != want:
            raise AssertionError(f"resume: losses {losses} differ from the "
                                 f"unbroken run's {want}")
        same = all(torch.equal(a, b) for a, b in zip(got_params, want_params))
        if not same or len(got_params) != len(want_params):
            raise AssertionError("resume: final params differ from the "
                                 "unbroken run's")
        log(f"resume: losses {want_losses} and final params "
            f"({len(got_params)} tensors) bit-equal to the unbroken run")
        self._driver_resume(cfg, path, ckdir, want_losses, want_params)

    def _driver_resume(self, cfg, path, ckdir, want_losses, want_params):
        """``launch.train.main --resume`` at full width from the step-2
        file of the supervised run (its step-4 file removed): the driver's
        two steps must give the unbroken run's losses 3-4, and its step-4
        file the unbroken run's final params."""
        import contextlib
        import io

        import torch

        from repro_torch.kernels import reassemble as K
        from repro_torch.launch.train import main as train_main
        from repro_torch.models.convert import train_state_from_reference
        from repro_torch.train import leaves
        from repro_torch.train import checkpoint as CK

        last = os.path.join(ckdir, f"step_{STEPS:08d}.ckpt")
        os.remove(last)
        argv = ["--arch", "phi4-mini-3.8b", "--layers", str(RESUME_LAYERS),
                "--steps", str(STEPS), "--global-batch", str(B),
                "--seq", str(S), "--microbatches", str(MICROBATCHES),
                "--lr", "1e-3", "--num-readers", "4", "--num-consumers", "16",
                "--device-ingest", "--data", path, "--ckpt-dir", ckdir,
                "--ckpt-every", str(RESUME_EVERY), "--resume"]
        out = io.StringIO()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary = train_main(argv)
        wall = time.perf_counter() - t0
        counts = dict(K.LAUNCHES)
        uploads = K.TABLE_UPLOADS
        self.launches["resume_driver"] = counts
        for line in out.getvalue().splitlines()[:3]:
            log(f"resume driver: {line}")
        log(f"resume driver: {' '.join(argv)}; {wall:.2f} s (host clock); "
            f"steps {summary['steps']}, failures {summary['failures']}, "
            f"losses {summary['first_loss']} {summary['final_loss']}; "
            f"launches {json.dumps(counts)}, chunk-table uploads {uploads}")
        tree, step = CK.restore_tree(last)
        got = leaves(train_state_from_reference(tree, cfg,
                                                device="cpu")["params"])
        if (summary["steps"], summary["failures"], step) != (
                STEPS - RESUME_EVERY, 0, STEPS):
            raise AssertionError(f"resume driver: summary {summary}, "
                                 f"last file of step {step}")
        if counts["reassemble_window"] != STEPS - RESUME_EVERY or uploads:
            raise AssertionError(f"resume driver: window launches {counts}, "
                                 f"uploads {uploads}")
        if [summary["first_loss"], summary["final_loss"]] != want_losses[
                RESUME_EVERY:]:
            raise AssertionError(f"resume driver: losses {summary} differ "
                                 f"from the unbroken run's {want_losses}")
        if len(got) != len(want_params) or not all(
                torch.equal(a, b) for a, b in zip(got, want_params)):
            raise AssertionError("resume driver: the params of its step-"
                                 f"{STEPS} file differ from the unbroken run's")
        log(f"resume driver: losses {want_losses[RESUME_EVERY:]} and the "
            f"params of its step-{STEPS} file bit-equal to the unbroken run")

    def compress(self):
        """One main-path step at ``ARCH_LAYERS`` layers with each gradient
        compression, whole-window ingest. With int8 the grads the step
        compresses are captured: its residual must be at most half a scale,
        and 20 rounds of error feedback on them must track 20 times the
        grads to within max |g| (the reference's bound)."""
        import torch

        from repro_torch.kernels import reassemble as K
        from repro_torch.train import grad_compress, leaves

        K.reset_launch_counts()
        for compression in ("bf16", "int8_ef"):
            cfg, path, _, params, opt, step_fn = self._trainer(
                compression=compression)
            pipe = self._pipeline(path, streaming=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seen = []
            ef_compress = grad_compress.ef_compress

            def capture(grads, ef, groups=None):
                seen.append((grads, groups))
                return ef_compress(grads, ef, groups)

            grad_compress.ef_compress = capture
            try:
                x, y = pipe.get_batch_device(0)
                batch = {"tokens": x, "labels": y}
                if compression == "int8_ef":
                    ef = grad_compress.init_ef_state(leaves(params))
                    params, opt, m, ef = step_fn(params, opt, batch, ef)
                else:
                    params, opt, m = step_fn(params, opt, batch)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            finally:
                grad_compress.ef_compress = ef_compress
                pipe.close()
            peak = torch.cuda.max_memory_allocated()
            log(f"compress {compression}: loss {loss:.6f}, grad norm "
                f"{gnorm:.6f}, max_memory_allocated {peak / 2**30:.2f} GiB; "
                f"{self.card_line}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"compress {compression}: loss {loss}, "
                                     f"grad norm {gnorm}")
            if compression == "int8_ef":
                (grads, groups), = seen
                worst, worst_ef = 0.0, 0.0
                for group in groups:
                    amax = max(grads[i].abs().max().item() for i in group)
                    r = max(ef[i].abs().max().item() for i in group)
                    worst_ef = max(worst_ef, r / (amax / 127.0))
                    g = [grads[i] for i in group]
                    res = grad_compress.init_ef_state(g)
                    applied = [torch.zeros_like(t) for t in g]
                    for _ in range(20):
                        _, deq, res = ef_compress(g, res, [range(len(g))])
                        for a, d in zip(applied, deq):
                            a.add_(d)
                    err = max((a - 20 * t).abs().max().item()
                              for a, t in zip(applied, g))
                    worst = max(worst, err / amax)
                    del g, res, applied
                log(f"compress int8_ef: {len(groups)} scale groups; residual "
                    f"at most {worst_ef:.6f} of a scale; after 20 rounds of "
                    f"error feedback the applied sum is within {worst:.6f} of "
                    f"max |g| of 20 g")
                if worst_ef > 0.5 * (1 + 1e-5) or not worst < 1.0:
                    raise AssertionError(f"compress int8_ef: residual "
                                         f"{worst_ef} scales, EF error "
                                         f"{worst} of max |g|")
                del grads, ef, seen
            del params, opt
            torch.cuda.empty_cache()
        counts = dict(K.LAUNCHES)
        self.launches["compress"] = counts
        if counts["reassemble_window"] != 2:
            raise AssertionError(f"compress: window launches {counts}")

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
        return busy

    # -- 8 ---------------------------------------------------------------------
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

    # -- 9 ---------------------------------------------------------------------
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

    # -- 10 --------------------------------------------------------------------
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
            # The five families served since, at B = 1 and B = 4.
            *[(b_, h_, kv_, 1, sk, HD, True, w_) for b_ in (1, 4)
              for h_, kv_, sk, w_ in FAMILY_DECODE],
            # qwen2-vl and whisper (decode, cross-attention, encoder).
            *[(*shape, 0) for shape in NEW_SHAPES],
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

        # The logit softcap, which the decode path alone computes: caps 30
        # and 50 at decode shapes (phi4-mini's and recurrentgemma's heads,
        # keys at the 32/64-key spans' edges, a full ring at B=4, windows),
        # against the plain version. q is scaled so that the scores bend:
        # in bf16 by 16 (scores up to about 60, at the cap), in fp32 by 4
        # (up to about 16, where cap 30's tanh bends them by 8 %). At the
        # cap an fp32 score of 30-50 carries tanh's ulp, 2-4e-6, into every
        # softmax weight, past the 1e-5 fp32 limit (1.26e-5 and 1.40e-5 on
        # an H100 with scores scaled by 16): fp32 rounding, on either side.
        capped = [(1, H, KV, 1, HD, 0), (1, H, KV, 129, HD, 0),
                  (1, H, KV, 2048, HD, 100), (1, RG_H, RG_KV, 17, RG_HD, 0),
                  (1, RG_H, RG_KV, 65, RG_HD, 0),
                  (4, RG_H, RG_KV, RG_WINDOW, RG_HD, 0),
                  (1, 32, 16, FAM_PROMPT + NEW, HD, G3_WINDOW)]
        for cap in (30.0, 50.0):
            for b, h, kv, sk, hd, window in capped:
                for dtype, tol, up in ((torch.float32, 1e-5, 4),
                                       (torch.bfloat16, 2e-2, 16)):
                    q, k, v = self._attn_inputs(rng, b, h, kv, 1, sk, hd,
                                                dtype)
                    q = q * up
                    self._close("flash_attention", FA.flash_attention_cuda(
                        q, k, v, window=window, softcap=cap),
                        ref.attention_ref(q, k, v, window=window,
                                          softcap=cap), tol)
        torch.cuda.synchronize()
        log(f"attention: decode_kernel with softcap 30 and 50, "
            f"{4 * len(capped)} cases within tolerance of the plain version; "
            f"max abs err {self.err['flash_attention']}")

        # A decode row gets the same bits alone and inside a batch of 4, and
        # on every run: the split plan depends on (Sk, hd) only.
        for h, kv, hd, sk, causal in (
                (H, KV, HD, PROMPT + NEW, True),
                (RG_H, RG_KV, RG_HD, RG_WINDOW, True),
                (32, 32, HD, FAM_PROMPT + NEW, True),
                (40, 10, HD, FAM_PROMPT + NEW, True),
                (16, 16, HD, FAM_PROMPT + NEW, True),
                (32, 16, HD, G3_WINDOW, True),
                (VLM_H, VLM_KV, VLM_HD, FAM_PROMPT + NEW, True),
                (VLM_H, VLM_KV, VLM_HD, 2048, True),
                (AUD_H, AUD_H, AUD_HD, FAM_PROMPT + NEW, True),
                (AUD_H, AUD_H, AUD_HD, AUD_FRAMES, False)):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = self._attn_inputs(rng, 4, h, kv, 1, sk, hd, dtype)
                kw = {"causal": causal}
                batch = FA.flash_attention_cuda(q, k, v, **kw)
                again = FA.flash_attention_cuda(q, k, v, **kw)
                alone = [FA.flash_attention_cuda(q[i:i + 1], k[i:i + 1],
                                                 v[i:i + 1], **kw)
                         for i in range(4)]
                if not (torch.equal(batch, again) and all(
                        torch.equal(batch[i:i + 1], alone[i])
                        for i in range(4))):
                    raise AssertionError(
                        f"flash_attention: decode rows (H={h}, hd={hd}, "
                        f"Sk={sk}, causal={causal}, {dtype}) differ between "
                        f"B=1 and B=4 or between runs")
        log("attention: decode rows bit-identical at B=1 and B=4 and across "
            "runs")

        # Time at the served decode shapes (the longest prefix the serve
        # phases reach; recurrentgemma's checked prefixes and full ring
        # too) and at the prefill shapes, bf16 as served.
        for key, h, kv, hd, sq, sk, window, *causal in (
                ("decode", H, KV, HD, 1, PROMPT + NEW, 0),
                ("prefill", H, KV, HD, 2048, 2048, 0),
                *[(f"decode_hd256_sk{sk}", RG_H, RG_KV, RG_HD, 1, sk, 0)
                  for sk in (1, 17, 129)],
                ("decode_hd256", RG_H, RG_KV, RG_HD, 1, PROMPT + NEW, 0),
                ("decode_hd256_ring", RG_H, RG_KV, RG_HD, 1, RG_WINDOW, 0),
                ("prefill_hd256", RG_H, RG_KV, RG_HD, RG_WINDOW, RG_WINDOW,
                 RG_WINDOW),
                # The five families' served decode shapes (the longest
                # prefix their phases reach), gemma3's full local ring and
                # the global prefix of its ring-wrap check.
                ("decode_codeqwen", 32, 32, HD, 1, FAM_PROMPT + NEW, 0),
                ("decode_phi3", 40, 10, HD, 1, FAM_PROMPT + NEW, 0),
                ("decode_gemma3", 32, 16, HD, 1, FAM_PROMPT + NEW, G3_WINDOW),
                ("decode_gemma3_ring", 32, 16, HD, 1, G3_WINDOW, 0),
                ("decode_gemma3_global", 32, 16, HD, 1, G3_WRAP_PROMPT, 0),
                ("decode_moe", 16, 16, HD, 1, FAM_PROMPT + NEW, 0),
                # qwen2-vl's and whisper's served shapes: decode at the
                # longest prefix their phases reach, whisper's
                # cross-attention and its encoder (no mask).
                ("decode_qwen2vl", VLM_H, VLM_KV, VLM_HD, 1,
                 FAM_PROMPT + NEW, 0),
                ("decode_whisper_self", AUD_H, AUD_H, AUD_HD, 1,
                 FAM_PROMPT + NEW, 0),
                ("decode_whisper_cross", AUD_H, AUD_H, AUD_HD, 1, AUD_FRAMES,
                 0, False),
                ("encoder_whisper", AUD_H, AUD_H, AUD_HD, AUD_FRAMES,
                 AUD_FRAMES, 0, False)):
            causal = causal[0] if causal else True
            q, k, v = self._attn_inputs(rng, 1, h, kv, sq, sk, hd,
                                        torch.bfloat16)
            # Kept (query, key) pairs under the end-aligned causal mask (a
            # window as long as the sequence keeps them all), or all of
            # them without a mask.
            pairs = (sum(min(sk, i + sk - sq + 1) for i in range(sq))
                     if causal else sq * sk)
            flops = 4 * h * hd * pairs
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = flops / BF16_PEAK * 1e3
            mask = f"causal window={window}" if causal else "no mask"
            r = {"shape": f"B=1 H={h} K={kv} Sq={sq} Sk={sk} hd={hd} bf16 "
                          f"{mask}", "bytes": nbytes,
                 "flops": flops, "bound_ms": max(b_bytes, b_ops),
                 "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                 "path": FA.launch_plan(tuple(q.shape), tuple(k.shape),
                                        q.dtype, window=window)["path"]}
            kernel = lambda: FA.flash_attention_cuda(  # noqa: E731
                q, k, v, causal=causal, window=window)
            plain = lambda: ref.attention_ref(  # noqa: E731
                q, k, v, causal=causal, window=window)
            # The yardstick: one PyTorch call for the same function (for
            # Sq = 1 every key is kept, which is no causal mask; a window
            # as long as the sequence masks nothing more than causal).
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal and sq > 1, enable_gqa=True)
            self._close("sdpa", library(), plain(), 2e-2)
            it = 200 if sq == 1 else 20
            times = alternate({"kernel": kernel, "plain": plain}, it, it, 5)
            r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
            r["library_ms"] = time_ms(library, it)
            self.timing[f"flash_attention/{key}"] = r
            log(f"time flash_attention/{key}: {json.dumps(r)}")
        log(f"attention: scaled_dot_product_attention within 2e-2 of the "
            f"plain version; max abs err {self.err['sdpa']}")
        self._attention_train()

    def _attention_train(self):
        """The training attention (``ops.flash_attention_train``'s two CUDA
        entries) at phi4-mini's microbatch (B=2, S=2048, 24 / 8 heads of
        128, causal) and at recurrentgemma's hd-256 MQA heads under windows
        of 2,048 and 1,024: the forward's output within 2^-5 of each row's
        largest magnitude (four bf16 steps; ``ref.row_relative_error``) and
        its lse within 1e-4 of the plain versions, each gradient within 2e-2
        of its largest magnitude, and the backward's bits equal on a second
        run; then both timed at phi4-mini's microbatch beside their plain
        versions and, as a yardstick only, the library's fused attention
        (``scaled_dot_product_attention``, forward; its backward alone); and
        the backward at recurrentgemma's B=1 shape (window 2,048), whose
        dK/dV key tiles are split over blocks (``FA.dkv_splits``), beside
        the same kernels with the split off and the plain version."""
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref

        def inputs(b, h, kv, hd, seed):
            g = torch.Generator(device=self.dev).manual_seed(seed)
            mk = lambda n: torch.randn(  # noqa: E731
                b, S, n, hd, generator=g, device=self.dev).to(
                torch.bfloat16).transpose(1, 2)
            return mk(h), mk(kv), mk(kv), mk(h)

        mb = B // MICROBATCHES
        for b, h, kv, hd, window in ((mb, H, KV, HD, 0),
                                     (1, RG_H, RG_KV, RG_HD, RG_WINDOW),
                                     (1, RG_H, RG_KV, RG_HD, G3_WINDOW)):
            q, k, v, do = inputs(b, h, kv, hd, hd + window)
            out, lse = FA.flash_attention_train_cuda(q, k, v, window=window)
            want, want_lse = ref.attention_train_ref(q, k, v, window=window)
            row_err = ref.row_relative_error(out, want)
            self.err["flash_attention_train_rows"] = max(
                self.err["flash_attention_train_rows"], row_err)
            if row_err > 2.0 ** -5:
                raise AssertionError(f"flash_attention_train: a row's error "
                                     f"is {row_err} of its largest magnitude")
            self._close("flash_attention_train", lse, want_lse, 1e-4)
            got = FA.flash_attention_backward_cuda(do, q, k, v, out, lse,
                                                   window=window)
            again = FA.flash_attention_backward_cuda(do, q, k, v, out, lse,
                                                     window=window)
            wants = ref.attention_train_bwd_ref(do, q, k, v, out, lse,
                                                window=window)
            for name, g_, a_, w_ in zip(("dq", "dk", "dv"), got, again, wants):
                if not torch.equal(g_, a_):
                    raise AssertionError(f"flash_attention_backward: {name} "
                                         f"differs between two runs")
                err = (g_.float() - w_.float()).abs().max().item()
                top = w_.float().abs().max().item()
                self.err["flash_attention_backward"] = max(
                    self.err["flash_attention_backward"], err)
                if err > 2e-2 * top:
                    raise AssertionError(f"flash_attention_backward: {name} "
                                         f"max abs err {err}, largest {top}")
            del got, again, wants
        torch.cuda.synchronize()
        log(f"attention: the training forward and backward within "
            f"tolerance of the plain versions at phi4-mini's microbatch and "
            f"hd 256 windows 2,048 / 1,024, the backward's bits the same "
            f"twice; output rows within "
            f"{self.err['flash_attention_train_rows']} of their largest, lse "
            f"max abs err {self.err['flash_attention_train']}, gradients "
            f"{self.err['flash_attention_backward']}")

        q, k, v, do = inputs(mb, H, KV, HD, 1)
        out, lse = FA.flash_attention_train_cuda(q, k, v)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                 enable_gqa=True)
        pairs = S * (S + 1) // 2
        cases = {
            "flash_attention_train": (
                4, lambda: FA.flash_attention_train_cuda(q, k, v),
                lambda: ref.attention_train_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)),
            "flash_attention_backward": (
                10, lambda: FA.flash_attention_backward_cuda(
                    do, q, k, v, out, lse),
                lambda: ref.attention_train_bwd_ref(do, q, k, v, out, lse),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                            retain_graph=True)),
        }
        for name, (per_pair, kernel, plain, library) in cases.items():
            flops = per_pair * mb * H * HD * pairs
            r = {"shape": f"B={mb} H={H} K={KV} S={S} hd={HD} bf16 causal",
                 "flops": flops, "bound_ms": flops / BF16_PEAK * 1e3,
                 "bound_by": "operations"}
            times = alternate({"kernel": kernel, "plain": plain}, 20, 5, 3)
            r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
            r["library_ms"] = time_ms(library, 20)
            self.timing[f"{name}/train"] = r
            log(f"time {name}/train: {json.dumps(r)}")

        q, k, v, do = inputs(1, RG_H, RG_KV, RG_HD, 2)
        out, lse = FA.flash_attention_train_cuda(q, k, v, window=RG_WINDOW)
        splits = FA.dkv_splits(1, RG_KV, S, S, RG_H, RG_HD,
                               FA._sm_count(self.dev.index or 0))
        auto = FA.dkv_splits

        def unsplit():
            FA.dkv_splits = lambda *a: 1
            try:
                return FA.flash_attention_backward_cuda(
                    do, q, k, v, out, lse, window=RG_WINDOW)
            finally:
                FA.dkv_splits = auto

        flops = 10 * RG_H * RG_HD * (S * (S + 1) // 2)
        r = {"shape": f"B=1 H={RG_H} K={RG_KV} S={S} hd={RG_HD} bf16 "
                      f"window {RG_WINDOW}",
             "splits": splits, "flops": flops,
             "bound_ms": flops / BF16_PEAK * 1e3, "bound_by": "operations"}
        times = alternate({
            "kernel": lambda: FA.flash_attention_backward_cuda(
                do, q, k, v, out, lse, window=RG_WINDOW),
            "unsplit": unsplit,
            "plain": lambda: ref.attention_train_bwd_ref(
                do, q, k, v, out, lse, window=RG_WINDOW)}, 20, 5, 3)
        r["ms"], r["unsplit_ms"], r["plain_ms"] = (
            times["kernel"], times["unsplit"], times["plain"])
        self.timing["flash_attention_backward/mqa"] = r
        log(f"time flash_attention_backward/mqa: {json.dumps(r)}")

    # -- 11 --------------------------------------------------------------------
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

    # -- 12 --------------------------------------------------------------------
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

    # -- 13, 14, 15 ------------------------------------------------------------
    def _serve_arch(self, arch, *, prompt_len, new, static_requests,
                    cont_requests, kmod, kfn, kname, want, check,
                    kernels=None, prefill=None, param_dtype="float32"):
        """Serve ``arch`` at full width through ``launch.serve``, static
        and continuous, with random weights from seed 0 in ``param_dtype``
        (handed to ``launch.serve.main``; the compute dtype stays the
        config's bf16). ``kmod.kfn`` is
        the wrapper of a kernel the decode call launches (``kname`` in
        ``kmod.LAUNCHES``); the first call whose arguments satisfy ``want``
        is captured and handed to ``check`` after the run. ``kernels``
        maps each kernel name to its module and its launches per decode
        call (default: ``kname``, once a layer). ``prefill`` maps a kernel
        name to its module and its launches per prefill forward, counted
        over the decode-replay check's two prefill forwards (an MoE
        config's at the capacity of :meth:`_dropless`). Returns the
        launches of both modes (and of those forwards) by kernel."""
        import numpy as np
        import torch

        from repro_torch.configs.registry import get_config
        from repro_torch.launch import serve as L
        from repro_torch.models import build_model, transformer
        from repro_torch.serve import sequential_oracle
        from repro_torch.train import leaves

        cfg = get_config(arch)
        kernels = kernels or {kname: (kmod, cfg.num_layers)}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = build_model(cfg.replace(param_dtype=param_dtype)).init(
            0, device=self.dev)
        torch.cuda.synchronize()
        n_params = cfg.param_counts()["total"]
        # What the card holds and a decode call reads: padded experts too.
        held = leaves(params)
        w_numel = sum(t.numel() for t in held)
        w_bytes = sum(t.numel() * t.element_size() for t in held)
        log(f"serve {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B params ({w_numel / 1e9:.3f} B held) in "
            f"{param_dtype} ({w_bytes / 1e9:.2f} GB), {cfg.dtype} compute; "
            f"weights made in {time.perf_counter() - t0:.1f} s")
        del held
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
            m = build_model(self._dropless(cfg, prompt_len).replace(
                dtype=dtype))
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
                f" a stream; it reads the {w_bytes / 1e9:.2f} GB of "
                f"{param_dtype} weights -> >= "
                f"{w_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s")
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
        self._ring_wrap(
            "ring_wrap", "recurrentgemma-2b", WRAP_LAYERS, WRAP_PROMPT,
            lambda n_att: {"rglru_scan_gated": (LRU, WRAP_LAYERS - n_att),
                           "rglru_scan": (LRU, 0),
                           "flash_attention": (FA, n_att)})

    def _ring_wrap(self, name, arch, layers, prompt_len, kernels):
        """The first ``layers`` layers of ``arch`` at full width in fp32
        (params and compute): one ``prompt_len``-token prompt replayed
        through decode, so that every local layer's ring (of its window's
        slots) wraps while a global layer keeps every position, against the
        plain prefill forward, which masks the window explicitly.
        ``kernels(n_att)`` maps each kernel counted to its module and its
        launches a token, given the attention layers."""
        import numpy as np
        import torch

        from repro_torch.configs.base import ATTN, ATTN_LOCAL
        from repro_torch.configs.registry import get_config
        from repro_torch.models import build_model

        cfg = get_config(arch).replace(num_layers=layers, dtype="float32",
                                       param_dtype="float32")
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        specs = [s for s in cfg.layer_schedule() if s.mixer in (ATTN,
                                                                 ATTN_LOCAL)]
        want_rings = [min(s.window, prompt_len) if s.mixer == ATTN_LOCAL
                      else prompt_len for s in specs]
        counted = kernels(len(specs))
        prompt = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, size=(1, prompt_len)).astype(np.int32)).to(
                self.dev)
        torch.cuda.synchronize()
        for mod, _ in counted.values():
            mod.reset_launch_counts()
        t = time.perf_counter()
        with torch.no_grad():
            state = model.init_decode_state(params, 1, prompt_len)
            for i in range(prompt_len):
                logits, state = model.decode(params, state,
                                             {"tokens": prompt[:, i:i + 1]})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = {k: mod.LAUNCHES[k] for k, (mod, _) in counted.items()}
            pre = model.prefill_logits(params, {"tokens": prompt})
        rings = [st.k.shape[1] for st in state.layers if hasattr(st, "k")]
        want = {k: n * prompt_len for k, (_, n) in counted.items()}
        if rings != want_rings or counts != want:
            raise AssertionError(f"{name}: rings {rings} (want {want_rings})"
                                 f", launches {counts} (want {want})")
        self.launches[name] = counts
        a, b = logits.float(), pre.float()
        rel = ((a - b).norm() / b.norm()).item()
        log(f"{name}: {arch}, {layers} layers ({len(specs)} attention, rings "
            f"of {rings} slots), fp32, a {prompt_len}-token prompt replayed "
            f"through decode in {wall:.1f} s ({wall / prompt_len * 1e3:.2f} "
            f"ms a call, host clock); launches {json.dumps(counts)}; last "
            f"logits vs the prefill forward: relative L2 {rel:.3e} (bound "
            f"{PREFILL_REL_TOL['float32']}), max abs "
            f"{(a - b).abs().max().item():.3e}, same argmax "
            f"{bool(a.argmax() == b.argmax())}")
        del params, state, logits, pre, a, b
        torch.cuda.empty_cache()
        if not rel <= PREFILL_REL_TOL["float32"]:
            raise AssertionError(f"{name}: decode replay differs from "
                                 f"prefill (relative L2 {rel})")

    @staticmethod
    def _dropless(cfg, prompt_len):
        """The config whose prefill forward a decode replay must equal. A
        decode call routes one token, whose top-k experts are distinct, so
        it never meets an expert's capacity; a prefill forward at the
        config's capacity factor (1.25) drops the choices past an expert's
        C slots, a function of the whole prompt. With capacity factor
        n_real / top_k, C is the prompt's length and no expert can
        overflow: the forward then computes what decode does (at S = 1 it
        keeps C = 1). A dense config is returned as it is."""
        if not cfg.num_experts:
            return cfg
        cf = cfg.num_experts / cfg.top_k
        C = max(1, int(cf * cfg.top_k * prompt_len / cfg.num_experts + 0.5))
        if C < prompt_len:
            raise AssertionError(f"{cfg.name}: capacity {C} < {prompt_len}")
        return cfg.replace(capacity_factor=cf)

    # -- 16-20 -----------------------------------------------------------------
    def serve_family(self, arch):
        """One of the five text families served since recurrentgemma, at
        full width and all its layers (FAMILIES), through the phases'
        common path; every layer is attention, so a decode call launches
        the flash-attention kernel once a layer. gemma3-27b then runs its
        ring-wrap check."""
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import ref

        phase, param_dtype = FAMILIES[arch]
        cfg = get_config(arch)
        h, kv = cfg.num_heads, cfg.num_kv_heads

        def check(fa, q, k, v, **kw):
            self._close("flash_attention", fa(q, k, v, **kw),
                        ref.attention_ref(q, k, v, **kw), 2e-2)
            return (f"q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
                    f"window {kw.get('window', 0)}: kernel within 2e-2 of the "
                    f"plain version")

        # One layer's served decode inputs at the longest prefix (B=1).
        self.launches[phase] = self._serve_arch(
            arch, prompt_len=FAM_PROMPT, new=NEW,
            static_requests=FAM_STATIC_REQUESTS,
            cont_requests=FAM_CONT_REQUESTS, kmod=FA,
            kfn="flash_attention_cuda", kname="flash_attention",
            want=lambda q, k, v, **kw: (q.shape[:3] == (1, h, 1)
                                        and k.shape[1:3] == (
                                            kv, FAM_PROMPT + NEW)),
            check=check, param_dtype=param_dtype)
        if arch == "gemma3-27b":
            self._ring_wrap("ring_wrap_gemma3", arch, G3_WRAP_LAYERS,
                            G3_WRAP_PROMPT,
                            lambda n_att: {"flash_attention": (FA, n_att)})

    # -- 21 --------------------------------------------------------------------
    def fileset(self):
        """Phase 21: the driver over three shards (leg a), a cold 2 GiB
        read in three modes (leg b) and the online tuners (leg c); every
        file lives under ``build/`` and is removed when the phase ends."""
        from repro_torch.io.posix import fs_block_size, supports_direct_io

        d = os.path.join(self.tmp, "fileset")
        os.makedirs(d)
        try:
            bs = fs_block_size(d)
            probe = os.path.join(d, "probe.bin")
            with open(probe, "wb") as f:
                f.write(b"\0" * bs)
            direct = supports_direct_io(probe)
            log(f"fileset: build/ is {fs_type(d)}, block {bs} B; "
                f"supports_direct_io {direct}")
            if not direct:
                log("fileset: no O_DIRECT open succeeds under build/: leg (a)"
                    " checks that --direct-io raises DirectIOError and runs "
                    "buffered; leg (b) drops its direct mode")
            for leg in (self._fileset_driver, self._fileset_cold,
                        self._fileset_tuners):
                t0 = time.perf_counter()
                leg(d, bs, direct)
                log(f"fileset: {leg.__name__} {time.perf_counter() - t0:.1f}"
                    f" s")
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def _fileset_corpus(self, d, bs):
        """Leg (a)'s corpus, also read by the ``process`` and ``numa``
        phases: 2 step windows and 517 tokens of uint32 ids from seed 0,
        as 3 shards whose interior starts lie inside each window (on the
        ``bs``-byte grid) and as one file; returns the shard paths, the
        single file, the tokens as int32 and the window's token count."""
        import numpy as np

        from repro_torch.configs.registry import get_config
        from repro_torch.data import write_token_shards
        from repro_torch.data.tokenfile import write_token_file

        w = B * (S + 1)                      # tokens of a step window
        unit = bs // 4                       # tokens of a block
        cut1, cut2 = (w // 2) // unit * unit, (3 * w // 2) // unit * unit
        if not (0 < cut1 < w < cut2 < 2 * w):
            raise AssertionError(f"fileset: {bs}-byte blocks leave no shard "
                                 f"start inside each {w}-token window")
        total = 2 * w + 517
        counts = [cut1, cut2 - cut1, total - cut2]
        vocab = get_config("phi4-mini-3.8b").vocab_size
        arr = np.random.default_rng(0).integers(0, vocab, total,
                                                dtype=np.uint32)
        shards = write_token_shards(os.path.join(d, "shards"), arr, counts)
        single = os.path.join(d, "single.bin")
        write_token_file(single, arr)
        log(f"fileset: shards of {counts} tokens (starts at {cut1} and "
            f"{cut2}; windows of {w}), {os.path.getsize(shards[-1])} B last")
        return shards, single, arr.view(np.int32), w

    def _driver_argv(self):
        return ["--arch", "phi4-mini-3.8b", "--layers", str(ARCH_LAYERS),
                "--steps", str(STEPS), "--global-batch", str(B),
                "--seq", str(S), "--microbatches", str(MICROBATCHES),
                "--lr", "1e-3", "--num-readers", str(FS_READERS),
                "--num-consumers", "16", "--device-ingest",
                "--ckpt-every", "1000"]

    def _driver_run(self, d, name, extra, spans=None):
        """One ``launch.train.main`` run (checkpoints off) with ``extra``
        flags: its batches, losses, host-clock times of each
        ``get_batch_device`` and step, summary, launch counts (zeroed just
        before the run), chunk-table uploads, and each reader set it
        started with its start() seconds. ``spans`` counts the parent's
        shard-file reads and those spanning two shards."""
        import contextlib
        import io

        import torch

        from repro_torch.core import buffers as B_
        from repro_torch.data import pipeline as P
        from repro_torch.io import posix
        from repro_torch.ipc.service import ServiceReaderSet
        from repro_torch.kernels import reassemble as K
        from repro_torch.launch import train as T

        class NoSave(T.AsyncCheckpointer):
            def save(self, tree, step, **kw):
                return None

        rec = {"batches": [], "losses": [], "t_batch": [], "t_step": [],
               "starts": []}
        spans = spans if spans is not None else [0, 0]
        pread_into = posix.ShardedFile.pread_into
        starts = {cls: cls.start for cls in (B_.BufferReaderSet,
                                              B_.ProcessReaderSet,
                                              ServiceReaderSet)}

        def timed(start):
            def timed_start(readers):
                t0 = time.perf_counter()
                try:
                    return start(readers)
                finally:
                    rec["starts"].append((readers,
                                          time.perf_counter() - t0))
            return timed_start

        def one_shard(self, offset, view, **kw):
            spans[0] += 1
            if self.shard_of(offset) != self.shard_of(offset + len(view) - 1):
                spans[1] += 1
            return pread_into(self, offset, view, **kw)

        get_batch_device = P.CkIOPipeline.get_batch_device
        make_train_step = T.make_train_step
        checkpointer = T.AsyncCheckpointer

        def timed_batch(pipe, step, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, y = get_batch_device(pipe, step, *a, **kw)
            rec["t_batch"].append((t0, time.perf_counter()))
            rec["batches"].append((x.cpu().numpy(), y.cpu().numpy()))
            return x, y

        def recorded_step(*a, **kw):
            inner = make_train_step(*a, **kw)

            def step_fn(params, opt, batch):
                p, o, m = inner(params, opt, batch)
                rec["losses"].append(float(m["loss"]))   # synchronizes
                rec["t_step"].append(time.perf_counter())
                return p, o, m
            return step_fn

        out = io.StringIO()
        P.CkIOPipeline.get_batch_device = timed_batch
        T.make_train_step = recorded_step
        T.AsyncCheckpointer = NoSave
        posix.ShardedFile.pread_into = one_shard
        for cls, start in starts.items():
            cls.start = timed(start)
        K.reset_launch_counts()
        try:
            with contextlib.redirect_stdout(out):
                summary = T.main([*self._driver_argv(), *extra, "--ckpt-dir",
                                  os.path.join(d, f"ck_{name}")])
        finally:
            P.CkIOPipeline.get_batch_device = get_batch_device
            T.make_train_step = make_train_step
            T.AsyncCheckpointer = checkpointer
            posix.ShardedFile.pread_into = pread_into
            for cls, start in starts.items():
                cls.start = start
        counts_k = dict(K.LAUNCHES)
        uploads = K.TABLE_UPLOADS
        torch.cuda.empty_cache()
        for line in out.getvalue().splitlines():
            if line.startswith("fileset:"):
                log(f"fileset driver: {line}")
        gb = [t1 - t0 for t0, t1 in rec["t_batch"]]
        step = [e - t0 for (t0, _), e in zip(rec["t_batch"], rec["t_step"])]
        rec.update(summary=summary, launches=counts_k, uploads=uploads,
                   gb_s=sum(gb[1:]) / len(gb[1:]),
                   step_s=sum(step[1:]) / len(step[1:]))
        if len(rec["batches"]) != STEPS or summary["steps"] != STEPS:
            raise AssertionError(f"{name}: {summary['steps']} steps, "
                                 f"{len(rec['batches'])} batches")
        if counts_k["reassemble_window"] != STEPS or uploads:
            raise AssertionError(f"{name}: window launches {counts_k}, "
                                 f"uploads {uploads}")
        return rec

    def _same_run(self, name, rec, want, what):
        """Batches and losses of ``rec`` bit-equal to ``want``'s."""
        import numpy as np

        for (xg, yg), (xw, yw) in zip(rec["batches"], want["batches"],
                                      strict=True):
            if not (np.array_equal(xg, xw) and np.array_equal(yg, yw)):
                raise AssertionError(f"{name}: batches differ from {what}")
        if rec["losses"] != want["losses"]:
            raise AssertionError(f"{name}: losses {rec['losses']} vs {what}"
                                 f" {want['losses']}")

    def _fileset_driver(self, d, bs, direct):
        """Leg (a): ``launch.train.main`` over ``--data a b c`` against a
        single file of the same tokens read with the blocking loop."""
        import numpy as np

        from repro_torch.io.posix import DirectIOError
        from repro_torch.launch import train as T

        shards, single, raw, w = self._fileset_corpus(d, bs)
        flags = ["--queue-depth", str(FS_DEPTH)]
        if direct:
            flags.append("--direct-io")
        else:
            try:
                T.main([*self._driver_argv(), "--data", *shards,
                        "--direct-io", "--ckpt-dir", os.path.join(d, "ck")])
            except DirectIOError as e:
                if shards[0] not in str(e):
                    raise AssertionError(f"fileset: DirectIOError does not "
                                         f"name {shards[0]}: {e}")
                log(f"fileset: --direct-io raised DirectIOError: {e}")
            else:
                raise AssertionError("fileset: --direct-io ran where no "
                                     "O_DIRECT open succeeds")
        self.fs_flags = flags
        spans = [0, 0]                       # reads, reads spanning shards
        runs = {}
        for name, extra in (("single", ["--data", single]),
                            ("window", ["--data", *shards, *flags]),
                            ("streamed", ["--data", *shards, *flags,
                                          "--streaming"])):
            rec = self._driver_run(d, f"fileset {name}", extra, spans)
            self.launches[f"fileset_{name}"] = rec["launches"]
            runs[name] = rec
            summary, read = rec["summary"], rec["summary"]["read"]
            starts = [s for _, s in rec["starts"]]
            shown = " ".join(a for a in extra if not a.startswith(d))
            log(f"fileset {name}: {shown}; losses "
                f"{rec['losses']}; launches {json.dumps(rec['launches'])}, "
                f"chunk-table uploads {rec['uploads']}; get_batch_device "
                f"{rec['gb_s'] * 1e3:.3f} ms of a {rec['step_s'] * 1e3:.1f} "
                f"ms step = {rec['gb_s'] / rec['step_s']:.4f} (mean of steps "
                f"2-{STEPS}, host clock), reader-set starts "
                f"{sum(starts) * 1e3:.3f} ms over {len(starts)} sessions; "
                f"{self.card_line}")
            log(f"fileset {name}: read {json.dumps(read)}; shards "
                f"{json.dumps(summary['shards'])}")
            # -- checks ---------------------------------------------------------
            for step, (x, y) in enumerate(rec["batches"]):
                win = raw[(step % 2) * w:(step % 2 + 1) * w].reshape(B, S + 1)
                if not (np.array_equal(x, win[:, :-1])
                        and np.array_equal(y, win[:, 1:])):
                    raise AssertionError(f"fileset {name} step {step}: batch "
                                         f"differs from the tokens")
            if name == "single":
                continue
            if read["inflight_hwm"][1] > FS_DEPTH or read["queue_depth"] != [
                    FS_DEPTH, FS_DEPTH]:
                raise AssertionError(f"fileset {name}: read {read}")
            if read["direct_io"] != [direct]:
                raise AssertionError(f"fileset {name}: direct_io {read}")
            sh = summary["shards"]
            if sum(sh["shard_bytes"].values()) != read["bytes_read"] or \
                    sh["shards_read"] != 3:
                raise AssertionError(f"fileset {name}: shard bytes {sh} vs "
                                     f"read {read}")
            self._same_run(f"fileset {name}", rec, runs["single"],
                           "the single file's")
        if spans[1] or not spans[0]:
            raise AssertionError(f"fileset: {spans[1]} of {spans[0]} shard-"
                                 f"file reads span two shards")
        # The thread backend's runs, held by the process and numa phases.
        self.fs_runs = runs
        log(f"fileset: batches and losses of both FileSet runs bit-equal to "
            f"the single file's; {spans[0]} shard-file reads, none spanning "
            f"two shards")

    def _cold_corpus(self, d):
        """Leg (b)'s corpus: three token-file shards of ``COLD_SHARD_MIB``
        MiB (interior ones of whole blocks; the last 517 tokens longer, so
        odd-sized), as one uint32 array and the shard paths."""
        import numpy as np

        from repro_torch.data import write_token_shards

        counts = [m << 18 for m in COLD_SHARD_MIB]
        counts[-1] += 517
        arr = np.random.default_rng(1).integers(0, 1 << 32, sum(counts),
                                                dtype=np.uint32)
        t0 = time.perf_counter()
        paths = write_token_shards(os.path.join(d, "cold"), arr, counts)
        for p in paths:
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        log(f"fileset cold: wrote {arr.nbytes} B in {len(paths)} shards in "
            f"{time.perf_counter() - t0:.2f} s (host clock, fsync included)")
        return arr, paths

    def _cold_read(self, ck, fh, paths, nbytes, offset, want):
        """One evicted session of ``nbytes`` at ``offset``: its bytes held
        against ``want``; returns (GB/s, cache state, session)."""
        import numpy as np

        state, detail = evict(paths)
        t0 = time.perf_counter()
        sess = ck.start_read_session_sync(fh, nbytes, offset)
        if not sess.readers.join(600):
            raise AssertionError("fileset: a cold session did not finish")
        dt = time.perf_counter() - t0
        got = np.frombuffer(ck.read_view_sync(sess, nbytes, offset),
                            dtype=np.uint8)
        same = np.array_equal(got, want)
        del got
        ck.close_read_session_sync(sess)
        if not same:
            raise AssertionError(f"fileset: session at {offset} of {nbytes}"
                                 f" B differs from the file")
        return nbytes / dt / 1e9, (state, detail), sess

    def _fileset_cold(self, d, bs, direct):
        """Leg (b): one 2 GiB session over three shards, in three modes."""
        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data import FileSet

        arr, paths = self._cold_corpus(d)
        self.cold = (arr, paths)
        want = arr.view("uint8")
        modes = [("blocking buffered", {}),
                 ("queue depth 8 buffered, 8 MiB readahead",
                  dict(queue_depth=FS_DEPTH, readahead_bytes=COLD_READAHEAD)),
                 ("queue depth 8 O_DIRECT",
                  dict(queue_depth=FS_DEPTH, direct_io=True))]
        for name, opts in modes[:3 if direct else 2]:
            ck = CkIO(num_pes=4, pes_per_node=4)
            fh = ck.open_fileset_sync(FileSet.build(paths), FileOptions(
                num_readers=8, **opts))
            try:
                gbs, (state, detail), sess = self._cold_read(
                    ck, fh, paths, arr.nbytes, 0, want)
                m = sess.metrics
            finally:
                ck.close_sync(fh)
            log(f"fileset cold: {name}: {arr.nbytes} B at {gbs:.3f} GB/s "
                f"(host clock, session start to last byte), cache {state} "
                f"({detail}), "
                f"submit {m.submit_backend or 'blocking'}, in flight <= "
                f"{m.inflight_hwm}, direct tails "
                f"{m.recovery.direct_tail_reads}, shard bytes "
                f"{json.dumps(m.shard_bytes)}, {fs_type(d)}; "
                f"{self.card_line}")
            if sum(m.shard_bytes.values()) != arr.nbytes or \
                    m.inflight_hwm > FS_DEPTH:
                raise AssertionError(f"fileset cold: {name}: shard bytes "
                                     f"{m.shard_bytes}, hwm {m.inflight_hwm}")

    def _fileset_tuners(self, d, bs, direct):
        """Leg (c): 8 evicted 256 MiB sessions of one shard file under each
        online tuner: the paths they chose and each session's GB/s."""
        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data.tokenfile import read_meta

        arr, paths = self.cold
        path = paths[0]
        base = read_meta(path).data_offset
        data = arr.view("uint8")
        for name, opts in (("adaptive_queue", dict(adaptive_queue=True)),
                           ("adaptive_splinters",
                            dict(adaptive_splinters=True))):
            ck = CkIO(num_pes=4, pes_per_node=4)
            fh = ck.open_sync(path, FileOptions(num_readers=FS_READERS,
                                                **opts))
            walk = []
            try:
                for i in range(TUNER_SESSIONS):
                    off = (i % 2) * TUNER_BYTES
                    gbs, (state, _), sess = self._cold_read(
                        ck, fh, [path], TUNER_BYTES, base + off,
                        data[off:off + TUNER_BYTES])
                    m, plan = sess.metrics, sess.plan
                    walk.append({
                        "GB/s": gbs, "cache": state,
                        "queue_depth": m.queue_depth,
                        "readahead_MiB": m.readahead_bytes / 2**20,
                        "submit": m.submit_backend or "blocking",
                        "splinter_MiB": [
                            b / 2**20 for b in (plan.reader_splinter_bytes
                                                or [plan.splinter_bytes])],
                        "in_flight_max": m.inflight_hwm,
                    })
            finally:
                ck.close_sync(fh)
            log(f"fileset tuners: {name}: {json.dumps(walk)}; "
                f"{self.card_line}")

    # -- 22, 23 ----------------------------------------------------------------
    def _thread_runs(self, phase):
        runs = getattr(self, "fs_runs", None)
        if not runs:
            raise AssertionError(f"{phase}: the fileset phase left no thread-"
                                 f"backend runs to hold this phase against")
        return runs

    def process(self):
        """Phase 22: the driver over leg (a)'s 3 shards on the process
        backend, whole-window and streamed, held against the fileset
        phase's thread-backend runs; then a worker crash under each
        recovery mode through a ``CkIOPipeline``."""
        from repro_torch.io.posix import fs_block_size
        from repro_torch.ipc.shm import shm_dir

        want = self._thread_runs("process")
        d = os.path.join(self.tmp, "process")
        os.makedirs(d)
        try:
            st = os.statvfs(shm_dir())
            log(f"process: arenas under {shm_dir()} ({fs_type(shm_dir())}): "
                f"{st.f_blocks * st.f_frsize} B, {st.f_bavail * st.f_frsize}"
                f" B free; each step session's arena is one window "
                f"({B * (S + 1) * 4} B) and its head")
            bs = fs_block_size(d)
            shards, _, raw, w = self._fileset_corpus(d, bs)
            flags = [*self.fs_flags, "--backend", "process", "--max-workers",
                     str(PROC_WORKERS)]
            for name, extra in (("window", []), ("streamed", ["--streaming"])):
                rec = self._driver_run(d, f"process {name}",
                                       ["--data", *shards, *flags, *extra])
                self.launches[f"process_{name}"] = rec["launches"]
                self._same_run(f"process {name}", rec, want[name],
                               "the thread backend's")
                served = self._served(f"process {name}", rec)
                attach = [m.worker_attach_s * 1e3 for m in served]
                self.proc_attach_ms = getattr(self, "proc_attach_ms",
                                              []) + attach
                read = rec["summary"]["read"]
                log(f"process {name}: losses {rec['losses']} (the thread "
                    f"backend's); launches {json.dumps(rec['launches'])}, "
                    f"chunk-table uploads {rec['uploads']}; submit "
                    f"{read['submit_backend']}, in flight <= "
                    f"{read['inflight_hwm'][1]}, direct tails "
                    f"{read['direct_tail_reads']} "
                    f"({read['direct_tail_bytes']} B); {len(served)} "
                    f"sessions served by {served[0].workers} worker "
                    f"processes each, spawn -> attached "
                    f"{min(attach):.1f}-{max(attach):.1f} ms (mean "
                    f"{sum(attach) / len(attach):.1f}; of which exec -> "
                    f"interpreter {read['worker_boot_ms']} ms, imports "
                    f"and spec {read['worker_import_ms']} ms, the slowest "
                    f"worker a session); get_batch_device "
                    f"{rec['gb_s'] * 1e3:.3f} ms of a "
                    f"{rec['step_s'] * 1e3:.1f} ms step = "
                    f"{rec['gb_s'] / rec['step_s']:.4f} (mean of steps "
                    f"2-{STEPS}, host clock; steps 1-{STEPS}: "
                    f"{[round((t1 - t0) * 1e3, 1) for t0, t1 in rec['t_batch']]}"
                    f" ms); {self.card_line}")
                if read["inflight_hwm"][1] > FS_DEPTH or \
                        read["degraded_sessions"]:
                    raise AssertionError(f"process {name}: read {read}")
            self._process_faults(d, bs, shards, raw, w)
        finally:
            shutil.rmtree(d, ignore_errors=True)

    def _served(self, name, rec):
        """The metrics of each process-backend session of a run that read
        bytes; fails unless worker processes served every one of them."""
        from repro_torch.core.buffers import ProcessReaderSet

        readers = [r for r, _ in rec["starts"]]
        if not readers or not all(isinstance(r, ProcessReaderSet)
                                  for r in readers):
            raise AssertionError(f"{name}: sessions on "
                                 f"{sorted({type(r).__name__ for r in readers})}")
        served = [r.metrics for r in readers if r.metrics.bytes_read]
        for m in served:
            pids = set(m.worker_pids)
            if (m.workers != PROC_WORKERS or len(pids) != m.workers
                    or os.getpid() in pids or 0 in pids
                    or m.recovery.degraded_mode):
                raise AssertionError(f"{name}: a session served by "
                                     f"{m.workers} workers {m.worker_pids}, "
                                     f"degraded {m.recovery.degraded_mode}")
        if len(served) < STEPS // 2:
            raise AssertionError(f"{name}: {len(served)} sessions read bytes")
        return served

    def _process_faults(self, d, bs, shards, raw, w):
        """A seeded worker crash after the go gate in every step session of
        a ``CkIOPipeline`` over the shards (O_DIRECT where it runs, 4
        workers), under ``respawn``, ``reissue`` and ``none``. The workers
        read with the blocking loop: at queue depth 2 or more the crash
        hook fires as a read is submitted, the reads still in flight die
        unpublished with the process, and the replacement inherits them
        and crashes at the same point again."""
        import numpy as np

        from repro_torch.core import CkIO, FaultPlan, FileOptions, WorkerCrashed
        from repro_torch.data import CkIOPipeline, FileSet
        from repro_torch.io.layout import plan_session
        from repro_torch.kernels import reassemble as K

        splinter = 3 * bs
        direct = "--direct-io" in self.fs_flags
        # Every reader of each step session gets 2 splinters, so the
        # plan's crash (after 1 of them) leaves a tail of 1 and a single
        # respawn finishes it.
        fs = FileSet.build(shards)
        sh = fs.sharded_file()
        for step in range(2):
            off = step * w * 4
            head = off % bs if direct else 0
            o, n = off - head, w * 4 + head
            bounds = sh.bounds_in(o, n)
            plan = plan_session(o, n, max(FS_READERS, len(bounds) + 1),
                                splinter_bytes=splinter,
                                hard_bounds=tuple(bounds) or None, align=bs)
            per = [len(plan.splinters_for_reader(r))
                   for r in range(plan.num_readers)]
            if per != [2] * FS_READERS:
                raise AssertionError(f"process faults: step {step} plans "
                                     f"{per} splinters a reader, not 2")
        sh.close()
        fault = FaultPlan(FAULT_SEED, num_readers=FS_READERS,
                          num_splinters=2 * FS_READERS)
        log(f"process faults: {json.dumps(fault.describe())}")

        def pipeline(recovery):
            ck = CkIO(num_pes=4, pes_per_node=4)
            seen = []
            ck.director.add_observer(seen.append)
            pipe = CkIOPipeline(
                fs, B, S, ckio=ck, num_consumers=16, device=self.dev,
                file_opts=FileOptions(
                    num_readers=FS_READERS, splinter_bytes=splinter,
                    backend="process", max_workers=PROC_WORKERS,
                    direct_io=direct,
                    recovery=recovery, fault_plan=fault,
                    worker_watchdog_s=FAULT_WATCHDOG_S))
            return pipe, seen

        for mode in ("respawn", "reissue"):
            pipe, seen = pipeline(mode)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                for step in range(pipe.num_steps):
                    x, y = pipe.get_batch_device(step)
                    win = raw[step * w:(step + 1) * w].reshape(B, S + 1)
                    if not (np.array_equal(x.cpu().numpy(), win[:, :-1])
                            and np.array_equal(y.cpu().numpy(), win[:, 1:])):
                        raise AssertionError(f"process faults {mode}: step "
                                             f"{step} differs from the "
                                             f"tokens")
                    want = self.fs_runs["window"]["batches"][step]
                    if not np.array_equal(x.cpu().numpy(), want[0]):
                        raise AssertionError(f"process faults {mode}: step "
                                             f"{step} differs from the "
                                             f"unbroken run")
            finally:
                pipe.close()
            dt = time.perf_counter() - t0
            self.launches[f"process_{mode}"] = dict(K.LAUNCHES)
            rec = [m.recovery for m in seen if m.bytes_read]
            got = [(r.respawns, r.reissues, r.reissued_splinters) for r in rec]
            log(f"process faults {mode}: {pipe.num_steps} batches bit-equal "
                f"to the unbroken run in {dt:.2f} s (host clock); per session "
                f"(respawns, reissues, splinters re-read) {got}, recovery "
                f"latency {[round(r.recovery_latency_s * 1e3, 1) for r in rec]}"
                f" ms; window launches {K.LAUNCHES['reassemble_window']}; "
                f"{self.card_line}")
            ok = (r.respawns == 1 if mode == "respawn" else r.reissues >= 1
                  for r in rec)
            if len(rec) != pipe.num_steps or not all(ok):
                raise AssertionError(f"process faults {mode}: {got}")
        pipe, _ = pipeline("none")
        t0 = time.perf_counter()
        try:
            pipe.get_batch_device(0)
        except WorkerCrashed as e:
            log(f"process faults none: WorkerCrashed after "
                f"{time.perf_counter() - t0:.3f} s (host clock): {e}")
        else:
            raise AssertionError("process faults none: no WorkerCrashed")
        finally:
            t1 = time.perf_counter()
            try:
                pipe.close()
            except WorkerCrashed as e:   # the prefetched session's, after
                log(f"process faults none: close re-raised after its "
                    f"teardown: {e}")
            log(f"process faults none: pipeline closed in "
                f"{time.perf_counter() - t1:.3f} s, file closed "
                f"{pipe.file.posix.closed}")
        if not pipe.file.posix.closed:
            raise AssertionError("process faults none: teardown unfinished")
        if time.perf_counter() - t0 > FAULT_WATCHDOG_S + 30:
            raise AssertionError("process faults none: too slow to fail")

    def service(self):
        """Phase 23: the pooled reader service. The driver of phase 21 (a)
        over the same 3 shards with ``--service --pool-workers 4``,
        whole-window and streamed, held against the fileset phase's
        thread-backend runs, each session's checkout beside the process
        phase's spawn -> attached; phi4-mini served ``--continuous
        --service``; the fault pipeline of phase 22 on the pool; and no
        ``ckiot-`` name of this process left after the shutdowns."""
        from repro_torch.io.posix import fs_block_size
        from repro_torch.ipc.shm import PREFIX, shm_dir

        want = self._thread_runs("service")
        spawn = getattr(self, "proc_attach_ms", None)
        if not spawn:
            raise AssertionError("service: the process phase left no spawn "
                                 "-> attached times to hold the checkout "
                                 "against")
        mark = f"-{os.getpid()}-"

        def own_segments():
            return sorted(n for n in os.listdir(shm_dir())
                          if n.startswith(PREFIX) and mark in n)

        before = own_segments()
        d = os.path.join(self.tmp, "service")
        os.makedirs(d)
        try:
            bs = fs_block_size(d)
            shards, _, raw, w = self._fileset_corpus(d, bs)
            flags = [*self.fs_flags, "--service", "--pool-workers",
                     str(PROC_WORKERS), "--max-workers", str(PROC_WORKERS)]
            for name, extra in (("window", []), ("streamed", ["--streaming"])):
                rec = self._driver_run(d, f"service {name}",
                                       ["--data", *shards, *flags, *extra])
                self.launches[f"service_{name}"] = rec["launches"]
                self._same_run(f"service {name}", rec, want[name],
                               "the thread backend's")
                self._service_sessions(f"service {name}", rec, spawn)
            self._service_serve()
            self._service_faults(d, bs, shards, raw, w)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        left = [n for n in own_segments() if n not in before]
        log(f"service: after every shutdown, {len(left)} ckiot- names of "
            f"this process in {shm_dir()}")
        if left:
            raise AssertionError(f"service: segments left: {left}")

    def _service_sessions(self, name, rec, spawn):
        """Checks and prints the pooled sessions of one driver run: every
        session that read bytes ran on the pool, on 1 to PROC_WORKERS
        workers (a session queued behind another is armed with the workers
        idle when one checks in, as the reference's dispatch grants them);
        each session's epoch, checkout and arena; a re-armed session's
        checkout at least 5x below the process phase's fastest spawn ->
        attached; ``get_batch_device`` and its share of each step. A
        session counts as re-armed when it was submitted after the pool's
        first attach: the sessions the pipeline starts at its construction
        wait for the pool's one-time start (the reference's
        ``perf_service`` drops its first session for the same reason)."""
        from repro_torch.ipc.service import ServiceReaderSet

        readers = [r for r, _ in rec["starts"]]
        if not readers or not all(isinstance(r, ServiceReaderSet)
                                  for r in readers):
            raise AssertionError(f"{name}: sessions on "
                                 f"{sorted({type(r).__name__ for r in readers})}")
        served = [r.metrics for r in readers if r.metrics.bytes_read]
        for m in served:
            pids = set(m.worker_pids)
            if (not m.pooled or not 1 <= m.workers <= PROC_WORKERS
                    or len(pids) != m.workers or os.getpid() in pids
                    or 0 in pids or m.recovery.degraded_mode):
                raise AssertionError(f"{name}: a session pooled {m.pooled}, "
                                     f"{m.workers} workers {m.worker_pids}")
        if len(served) < STEPS // 2:
            raise AssertionError(f"{name}: {len(served)} sessions read bytes")
        svc, read = rec["summary"]["service"], rec["summary"]["read"]
        if svc["workers_evicted"] or svc["sessions_failed"] or \
                svc["rejected"] or read["inflight_hwm"][1] > FS_DEPTH:
            raise AssertionError(f"{name}: service {svc}, read {read}")
        states = [(r.metrics, r._svc_state) for r in readers
                  if r.metrics.bytes_read]
        t_up = min(st.t_submit + m.service_checkout_s for m, st in states)
        rearmed = [m.service_checkout_s * 1e3 for m, st in states
                   if st.t_submit >= t_up]
        first = [m for m in served if m.worker_boot_s]
        steps = [(round((t1 - t0) * 1e3, 3),
                  round((t1 - t0) / (e - t0), 4))
                 for (t0, t1), e in zip(rec["t_batch"], rec["t_step"])]
        log(f"{name}: losses {rec['losses']} (the thread backend's); "
            f"launches {json.dumps(rec['launches'])}, chunk-table uploads "
            f"{rec['uploads']}; sessions (epoch, workers, checkout ms, "
            f"arena): "
            f"{[(m.service_epoch, m.workers, round(m.service_checkout_s * 1e3, 3), 'hit' if m.arena_recycled else 'miss') for m in served]}"
            f"; first sessions' worker exec -> interpreter "
            f"{[round(m.worker_boot_s * 1e3, 1) for m in first]} ms, imports "
            f"{[round(m.worker_import_s * 1e3, 1) for m in first]} ms; "
            f"process phase spawn -> attached {min(spawn):.1f}-"
            f"{max(spawn):.1f} ms; get_batch_device ms and share of each "
            f"step {steps} (host clock); service {json.dumps(svc)}; "
            f"{self.card_line}")
        if not rearmed:
            raise AssertionError(f"{name}: no re-armed session")
        ratio = min(spawn) / max(rearmed)
        log(f"{name}: {len(rearmed)} re-armed sessions, checkout "
            f"{min(rearmed):.3f}-{max(rearmed):.3f} ms, {ratio:.1f}x below "
            f"the process phase's fastest spawn -> attached "
            f"({min(spawn):.1f} ms)")
        if ratio < 5:
            raise AssertionError(f"{name}: checkout only {ratio:.2f}x below "
                                 f"spawn -> attached")

    def _service_serve(self):
        """phi4-mini at full width with ``ARCH_LAYERS`` of its 32 layers
        (the depth is the serve phase's subject, the pool this one's),
        random weights from seed 0, served ``--continuous --service
        --pool-workers 2 --layers ARCH_LAYERS``: every request's session on
        the pool, tokens equal to the sequential oracle's, one
        flash-attention launch a layer a decode call."""
        import numpy as np
        import torch

        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.launch import serve as L
        from repro_torch.models import build_model, transformer
        from repro_torch.serve import sequential_oracle

        cfg = get_config("phi4-mini-3.8b").replace(num_layers=ARCH_LAYERS)
        t0 = time.perf_counter()
        params = build_model(cfg.replace(param_dtype="float32")).init(
            0, device=self.dev)
        torch.cuda.synchronize()
        log(f"service serve: phi4-mini ({cfg.num_layers} layers) weights "
            f"made in {time.perf_counter() - t0:.1f} s")
        argv = ["--arch", cfg.name, "--layers", str(cfg.num_layers),
                "--batch", str(SLOTS), "--prompt-len",
                str(PROMPT), "--max-new", str(NEW), "--data",
                os.path.join(self.tmp, "prompts_service.bin"), "--requests",
                str(CONT_REQUESTS), "--continuous", "--arrival-rate",
                str(ARRIVAL_RATE), "--service", "--pool-workers", "2"]
        decode_step = transformer.decode_step
        calls = [0]

        def counting(*a, **kw):
            calls[0] += 1
            return decode_step(*a, **kw)

        transformer.decode_step = counting
        try:
            torch.cuda.synchronize()
            FA.reset_launch_counts()
            t = time.perf_counter()
            run = L.main(argv, params=params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = FA.LAUNCHES["flash_attention"]
        finally:
            transformer.decode_step = decode_step
        self.launches["service_serve"] = {"flash_attention": launches}
        m = run.metrics
        if launches != cfg.num_layers * calls[0] or not calls[0]:
            raise AssertionError(f"service serve: flash_attention launched "
                                 f"{launches} times in {calls[0]} decode "
                                 f"calls")
        if not (run.summary["all_completed"]
                and m.pooled_sessions == CONT_REQUESTS == len(run.requests)
                and m.ingest_bytes_copied == 0):
            raise AssertionError(f"service serve: {run.summary}, pooled "
                                 f"{m.pooled_sessions}")
        by_rid = sorted(run.requests, key=lambda r: r.rid)
        prompts = [run.corpus[r.row_start:r.row_start + r.num_rows]
                   for r in by_rid]
        oracle = sequential_oracle(run.engine, prompts, [NEW] * len(by_rid))
        if [r.result for r in by_rid] != oracle:
            raise AssertionError("service serve: tokens differ from the "
                                 "sequential oracle on the same engine")
        pct = {w: m.latency_percentiles(w)
               for w in ("ingest", "first_token", "e2e")}
        log(f"service serve: {len(by_rid)} requests, each session on the "
            f"pool (pooled_sessions {m.pooled_sessions}), token streams "
            f"bit-identical to the sequential oracle; {calls[0]} decode "
            f"calls, flash_attention {launches} = {cfg.num_layers} x "
            f"{calls[0]}; {run.summary['new_tokens']} new tokens in "
            f"{wall:.2f} s (host clock); arrival -> "
            + ", ".join(f"{w} p50 {p['p50']:.4f} s p99 {p['p99']:.4f} s"
                        for w, p in pct.items())
            + f"; busy events {m.busy_events}; {self.card_line}")
        del params, run
        torch.cuda.empty_cache()

    def _service_faults(self, d, bs, shards, raw, w):
        """Phase 22's fault pipeline on a pool of PROC_WORKERS workers:
        ``respawn`` and ``reissue`` bit-equal to the unbroken run; under
        ``none`` the crashed session fails alone while a sibling session on
        the same pool completes, and the pool serves the next session."""
        import numpy as np

        from repro_torch.core import CkIO, FaultPlan, FileOptions, WorkerCrashed
        from repro_torch.data import CkIOPipeline, FileSet
        from repro_torch.ipc.service import ReaderService, ServiceOptions
        from repro_torch.kernels import reassemble as K

        splinter = 3 * bs
        direct = "--direct-io" in self.fs_flags
        fs = FileSet.build(shards)
        fault = FaultPlan(FAULT_SEED, num_readers=FS_READERS,
                          num_splinters=2 * FS_READERS)

        def opts(**kw):
            return FileOptions(num_readers=FS_READERS,
                               splinter_bytes=splinter, backend="process",
                               max_workers=PROC_WORKERS, direct_io=direct,
                               **kw)

        for mode in ("respawn", "reissue"):
            svc = ReaderService(ServiceOptions(pool_workers=PROC_WORKERS))
            ck = CkIO(num_pes=4, pes_per_node=4)
            seen = []
            ck.director.add_observer(seen.append)
            t0 = time.perf_counter()
            try:
                pipe = CkIOPipeline(fs, B, S, ckio=ck, num_consumers=16,
                                    device=self.dev, service=svc,
                                    file_opts=opts(recovery=mode,
                                                   fault_plan=fault))
                K.reset_launch_counts()
                try:
                    for step in range(pipe.num_steps):
                        x, y = pipe.get_batch_device(step)
                        win = raw[step * w:(step + 1) * w].reshape(B, S + 1)
                        if not (np.array_equal(x.cpu().numpy(), win[:, :-1])
                                and np.array_equal(y.cpu().numpy(),
                                                   win[:, 1:])):
                            raise AssertionError(f"service faults {mode}: "
                                                 f"step {step} differs")
                finally:
                    pipe.close()
                self.launches[f"service_{mode}"] = dict(K.LAUNCHES)
            finally:
                svc.shutdown()
            dt = time.perf_counter() - t0
            rec = [m for m in seen if m.bytes_read]
            got = [(m.recovery.respawns, m.recovery.reissues,
                    m.recovery.reissued_splinters) for m in rec]
            sm = svc.metrics.summary()
            log(f"service faults {mode}: {pipe.num_steps} batches bit-equal "
                f"to the tokens in {dt:.2f} s with the pool's start (host "
                f"clock); per session (respawns, reissues, splinters re-read)"
                f" {got}; evicted {sm['workers_evicted']:.0f}, spawned "
                f"{sm['workers_spawned']:.0f}; {self.card_line}")
            ok = (m.pooled and (m.recovery.respawns == 1 if mode == "respawn"
                                else m.recovery.reissues >= 1) for m in rec)
            if len(rec) != pipe.num_steps or not all(ok) or \
                    sm["sessions_failed"]:
                raise AssertionError(f"service faults {mode}: {got}, {sm}")
        # recovery="none": A crashes, its sibling B completes, C follows.
        svc = ReaderService(ServiceOptions(pool_workers=PROC_WORKERS))
        ck = CkIO(num_pes=4, pes_per_node=4)
        ck.director.attach_service(svc)
        n = w * 4
        want = raw[:w].tobytes()
        try:
            fh_bad = ck.open_fileset_sync(fs, FileOptions(
                num_readers=FS_READERS, splinter_bytes=splinter,
                backend="process", max_workers=2, direct_io=direct,
                fault_plan=fault))
            fh_ok = ck.open_fileset_sync(fs, FileOptions(
                num_readers=FS_READERS, splinter_bytes=splinter,
                backend="process", max_workers=2, direct_io=direct))
            t0 = time.perf_counter()
            sa = ck.start_read_session_sync(fh_bad, n, 0, timeout=120)
            sb = ck.start_read_session_sync(fh_ok, n, 0, timeout=120)
            try:
                ck.read_view_sync(sa, n, 0, timeout=120)
            except WorkerCrashed as e:
                log(f"service faults none: session A failed after "
                    f"{time.perf_counter() - t0:.3f} s (host clock): {e}")
            else:
                raise AssertionError("service faults none: no WorkerCrashed")
            if bytes(ck.read_view_sync(sb, n, 0, timeout=120)) != want:
                raise AssertionError("service faults none: sibling differs")
            pooled = (sa.metrics.pooled, sb.metrics.pooled)
            ck.close_read_session_sync(sa)
            ck.close_read_session_sync(sb)
            t1 = time.perf_counter()
            sc = ck.start_read_session_sync(fh_ok, n, 0, timeout=120)
            if bytes(ck.read_view_sync(sc, n, 0, timeout=120)) != want:
                raise AssertionError("service faults none: next differs")
            mc = sc.metrics
            ck.close_read_session_sync(sc)
            ck.close_sync(fh_bad)
            ck.close_sync(fh_ok)
        finally:
            svc.shutdown()
        sm = svc.metrics.summary()
        log(f"service faults none: sibling B bit-equal; next session C "
            f"bit-equal in {time.perf_counter() - t1:.3f} s (host clock; "
            f"checkout {mc.service_checkout_s * 1e3:.1f} ms, on "
            f"{mc.workers} workers, the evicted one's replacement started "
            f"lazily); failed {sm['sessions_failed']:.0f}, evicted "
            f"{sm['workers_evicted']:.0f}, pool {svc.pool_size()}")
        if (pooled != (True, True) or not mc.pooled
                or sm["sessions_failed"] != 1 or sm["workers_evicted"] != 1):
            raise AssertionError(f"service faults none: pooled {pooled}, "
                                 f"{mc.pooled}; {sm}")

    def numa(self):
        """Phase 24: the host's NUMA domains, then the driver with
        ``--topology auto --numa-pin`` under ``domain_spread`` and
        ``near_consumers`` on both backends, held against the fileset
        phase's plain run."""
        import glob

        from repro_torch.io.numa import PAGE_BYTES, detect_numa_domains
        from repro_torch.io.posix import fs_block_size

        want = self._thread_runs("numa")["window"]
        nodes = {os.path.basename(p): open(os.path.join(p, "cpulist")).read(
            ).strip() for p in sorted(glob.glob(
                "/sys/devices/system/node/node[0-9]*"))}
        bus = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        bus = bus.splitlines()[0] if bus else ""
        node_file = f"/sys/bus/pci/devices/{bus[-12:].lower()}/numa_node"
        card_node = (open(node_file).read().strip()
                     if os.path.exists(node_file) else "not readable")
        domains = detect_numa_domains()
        log(f"numa: sysfs nodes {json.dumps(nodes)}; detected domains "
            f"{[f'{len(c)} cpus {c[0]}-{c[-1]}' for c in domains]}; "
            f"os.sched_getaffinity {len(os.sched_getaffinity(0))} cpus; "
            f"card {bus} numa_node {card_node}")
        if len(domains) == 1:
            log("numa: one domain: pinning and first touch run, but place "
                "nothing; this checks the plumbing only")
        d = os.path.join(self.tmp, "numa")
        os.makedirs(d)
        try:
            shards, _, _, _ = self._fileset_corpus(d, fs_block_size(d))
            for backend in ("thread", "process"):
                for placement in ("domain_spread", "near_consumers"):
                    name = f"{backend}_{placement}"
                    extra = ["--data", *shards, *self.fs_flags,
                             "--topology", "auto", "--numa-pin",
                             "--placement", placement, "--backend", backend]
                    if backend == "process":
                        extra += ["--max-workers", str(PROC_WORKERS)]
                    rec = self._driver_run(d, f"numa {name}", extra)
                    self.launches[f"numa_{name}"] = rec["launches"]
                    self._same_run(f"numa {name}", rec, want,
                                   "the plain run's")
                    if backend == "process":
                        self._served(f"numa {name}", rec)
                    loc = rec["summary"]["locality"]
                    arena_pages = sum(-(-r.plan.nbytes // PAGE_BYTES)
                                      for r, _ in rec["starts"])
                    log(f"numa {name}: batches and losses those of the plain"
                        f" run; locality {json.dumps(loc)}; first-touched "
                        f"pages {loc['prefault_pages']:.0f} of "
                        f"{arena_pages} arena pages over "
                        f"{len(rec['starts'])} sessions; get_batch_device "
                        f"{rec['gb_s'] * 1e3:.3f} ms of a "
                        f"{rec['step_s'] * 1e3:.1f} ms step; "
                        f"{self.card_line}")
                    if (loc["pinned_threads"] + loc["pin_failures"] < 1
                            or loc["prefault_pages"] < 1
                            or loc["same_domain_bytes"]
                            + loc["cross_domain_bytes"] < 1):
                        raise AssertionError(f"numa {name}: locality {loc}")
        finally:
            shutil.rmtree(d, ignore_errors=True)

    # -- result ----------------------------------------------------------------
    # -- 25, 26 ----------------------------------------------------------------
    def _lib_model(self, arch):
        """``arch`` at full width and depth, fp32 params from seed 0, bf16
        compute; prints its weights."""
        import torch

        from repro_torch.configs.registry import get_config
        from repro_torch.models import build_model
        from repro_torch.train import leaves

        cfg = get_config(arch)
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(0, device=self.dev)
        torch.cuda.synchronize()
        w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
        log(f"{arch}: {cfg.num_layers} layers"
            + (f" + {cfg.encoder_layers} encoder layers" if cfg.is_encdec
               else "")
            + f", d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
            f"heads at hd {cfg.resolved_head_dim}, "
            f"{cfg.param_counts()['total'] / 1e9:.3f} B params in fp32 "
            f"({w_bytes / 1e9:.2f} GB), {cfg.dtype} compute; weights made in "
            f"{time.perf_counter() - t0:.1f} s")
        return cfg, model, params, w_bytes

    def _count(self, module, fn_name, counter):
        """Wrap ``module.fn_name`` so each call adds one to
        ``counter[fn_name]``; returns the undo."""
        real = getattr(module, fn_name)

        def counting(*a, **kw):
            counter[fn_name] = counter.get(fn_name, 0) + 1
            return real(*a, **kw)

        setattr(module, fn_name, counting)
        return lambda: setattr(module, fn_name, real)

    def _lib_continuous(self, name, model, params, prompts, frames=None):
        """``prompts`` (n, L) as a 3-shard ``FileSet`` under ``build/``,
        one CkIO session a request through a ``RequestIngester``, served
        by a ``ContinuousBatcher`` over a ``ModelEngine`` of SLOTS slots
        (all requests submitted at once); tokens must equal the sequential
        oracle's on the same engine. Returns the served requests."""
        from repro_torch.core import CkIO, FileOptions, ServeMetrics
        from repro_torch.data import FileSet, write_token_shards
        from repro_torch.serve import (ContinuousBatcher, ModelEngine,
                                       RequestIngester, ServeRequest,
                                       sequential_oracle)

        n, L = prompts.shape
        per = n * L // 3
        fs = FileSet.build(write_token_shards(
            os.path.join(self.tmp, f"{name}_prompts"), prompts.reshape(-1),
            [per, per, n * L - 2 * per]))
        ck = CkIO(num_pes=2)
        metrics = ServeMetrics()
        ck.director.add_observer(metrics.record_session)
        fh = ck.open_fileset_sync(fs, FileOptions(num_readers=2))
        engine = ModelEngine(model, params, slots=SLOTS,
                             seq_budget=L + NEW + 8, frames=frames)
        ing = RequestIngester(ck, fh, fs, metrics, max_pending=8)
        bat = ContinuousBatcher(engine, ing)
        for i in range(n):
            ing.submit(ServeRequest(rid=i, row_start=i * L, num_rows=L,
                                    max_new_tokens=NEW))
        t = time.perf_counter()
        done = sorted(bat.run(), key=lambda r: r.rid)
        wall = time.perf_counter() - t
        ck.close_sync(fh)
        for which in ("first_token", "e2e"):
            p = metrics.latency_percentiles(which)
            log(f"{name} continuous: arrival -> {which} p50 {p['p50']:.4f} s,"
                f" p99 {p['p99']:.4f} s")
        oracle = sequential_oracle(engine, list(prompts), [NEW] * n)
        if [r.result for r in done] != oracle:
            raise AssertionError(f"{name} continuous: tokens differ from the "
                                 f"sequential oracle on the same engine")
        log(f"{name} continuous: {n} requests on {SLOTS} slots, "
            f"{n * NEW} new tokens in {wall:.2f} s; {n} token streams "
            f"bit-identical to the sequential oracle")
        return done

    def _lib_replay(self, name, model, params, steps, feed, tol_dtype,
                    pre_batch, init):
        """Replay ``feed(t)``, t < ``steps``, through decode from
        ``init(model)`` and hold
        the last logits against ``model.prefill_logits(pre_batch)``
        (relative L2 under PREFILL_REL_TOL[tol_dtype])."""
        import torch

        with torch.no_grad():
            state = init(model)
            for t in range(steps):
                logits, state = model.decode(params, state, feed(t))
            pre = model.prefill_logits(params, pre_batch)
        a, b = logits.float(), pre.float()
        rel = ((a - b).norm() / b.norm()).item()
        tol = PREFILL_REL_TOL[tol_dtype]
        log(f"{name}: {tol_dtype} decode-replay logits vs the prefill "
            f"forward: relative L2 {rel:.3e} (bound {tol}), max abs "
            f"{(a - b).abs().max().item():.3e}, same argmax "
            f"{bool(a.argmax() == b.argmax())}")
        if not (rel <= tol and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{name}: {tol_dtype} decode replay differs "
                                 f"from the prefill forward ({rel})")
        return state, logits

    def _lib_time(self, name, model, params, state, logits, w_bytes, fname):
        """NEW synchronized B=1 decode calls past ``state`` (host clock),
        then 8 more under the profiler: device time a call, and the busy
        share as that over the synchronized wall time a call (the
        profiler's own wall time carries its start-up)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        def calls(n):
            nonlocal state, logits
            for _ in range(n):
                tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                logits, state = model.decode(params, state, {"tokens": tok})

        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            calls(NEW)
            torch.cuda.synchronize()
            per_call = (time.perf_counter() - t) / NEW
            log(f"{name}: B=1 bf16 decode call {per_call * 1e3:.2f} ms (host "
                f"clock, synchronized) = {1 / per_call:.1f} tokens/s a "
                f"stream; it reads {w_bytes / 1e9:.2f} GB of fp32 weights -> "
                f">= {w_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s")
            t = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                calls(8)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy = self._report_profile(prof, wall, 8, "decode call", fname) / 8
        log(f"{name}: device time {busy * 1e3:.2f} ms a decode call "
            f"(profiler) = {busy / per_call:.3f} of the synchronized "
            f"{per_call * 1e3:.2f} ms call")

    def serve_vlm(self):
        """Phase 25: qwen2-vl-2b through the library (the serve driver
        refuses it, as the reference's does)."""
        import numpy as np
        import torch

        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data import read_meta, write_token_file
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.models import transformer
        from repro_torch.serve import BatchServer, Request

        cfg, model, params, w_bytes = self._lib_model("qwen2-vl-2b")
        if (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim) != (VLM_LAYERS, VLM_H, VLM_KV, VLM_HD):
            raise AssertionError(f"qwen2-vl-2b: {cfg}")
        rng = np.random.default_rng(21)
        n_all = LIB_STATIC_REQUESTS + LIB_CONT_REQUESTS
        prompts = rng.integers(0, cfg.vocab_size, size=(n_all, FAM_PROMPT),
                               dtype=np.int32)
        count = {}
        total = 0

        def run(mode, fn):
            nonlocal total
            torch.cuda.synchronize()
            FA.reset_launch_counts()
            count.clear()
            undo = self._count(transformer, "decode_step", count)
            t = time.perf_counter()
            try:
                out = fn()
                torch.cuda.synchronize()
            finally:
                undo()
            wall = time.perf_counter() - t
            n, got = count.get("decode_step", 0), FA.LAUNCHES["flash_attention"]
            if n == 0 or got != VLM_LAYERS * n:
                raise AssertionError(f"serve_vlm {mode}: flash_attention "
                                     f"launched {got} times in {n} decode "
                                     f"calls, not {VLM_LAYERS} a call")
            log(f"serve_vlm {mode}: {n} decode calls in {wall:.2f} s = "
                f"{wall / n * 1e3:.2f} ms a call (host clock, mode wall time "
                f"over calls); flash_attention {got} = {VLM_LAYERS} x {n}")
            total += got
            return out

        # Static: BatchServer over one CkIO bulk read of the prompts.
        path = os.path.join(self.tmp, "vlm_prompts.bin")
        write_token_file(path, prompts[:LIB_STATIC_REQUESTS].reshape(-1))
        meta = read_meta(path)
        ck = CkIO(num_pes=2)
        fh = ck.open_sync(path, FileOptions(num_readers=2))
        off, nbytes = meta.byte_range_for_rows(0, meta.num_rows)
        sess = ck.start_read_session_sync(fh, nbytes, off)
        buf = np.empty(meta.num_rows, dtype=meta.dtype)
        ck.read_sync(sess, nbytes, off, memoryview(buf).cast("B"))
        ck.close_read_session_sync(sess)
        ck.close_sync(fh)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW)
                for i, p in enumerate(buf.reshape(-1, FAM_PROMPT))]
        done = run("static", lambda: BatchServer(
            model, params, batch_size=SLOTS, bucket=FAM_PROMPT).serve(reqs))
        if not all(len(r.result) == NEW and all(
                0 <= int(x) < cfg.vocab_size for x in r.result) for r in done):
            raise AssertionError("serve_vlm static: incomplete results")
        log(f"serve_vlm static: {len(done)} requests at batch {SLOTS}, "
            f"{len(done) * NEW} new tokens")
        run("continuous", lambda: self._lib_continuous(
            "serve_vlm", model, params, prompts[LIB_STATIC_REQUESTS:]))

        # Patch embeddings: a prefill forward at distinct (t, h, w)
        # positions (a 4 x 4 patch grid at each of 4 time steps), then the
        # embeddings replayed through decode against the prefill forward
        # over them at broadcast positions.
        emb = (torch.randn((1, FAM_PROMPT, cfg.d_model), generator=
                           torch.Generator(device=self.dev).manual_seed(3),
                           device=self.dev) * 0.02)
        i = torch.arange(FAM_PROMPT, device=self.dev)
        pos = torch.stack([i // 16, (i // 4) % 4, i % 4], -1)[None].to(
            torch.int32)
        with torch.no_grad():
            lg = model.prefill_logits(params, {"embeds": emb,
                                               "positions": pos})
        if lg.shape != (1, 1, cfg.vocab_size) or not bool(
                torch.isfinite(lg).all()):
            raise AssertionError(f"serve_vlm: embeddings prefill {lg.shape}")
        log(f"serve_vlm: patch-embedding prefill ({FAM_PROMPT} patches, "
            f"M-RoPE sections {cfg.mrope_sections} at distinct (t, h, w)): "
            f"finite logits {tuple(lg.shape)}")
        for dtype in ("bfloat16", "float32"):
            m = type(model)(cfg.replace(dtype=dtype))
            state, logits = run(f"embeds replay {dtype}", lambda: self._lib_replay(
                f"serve_vlm embeds", m, params, FAM_PROMPT,
                lambda t: {"embeds": emb[:, t:t + 1]}, dtype,
                {"embeds": emb},
                lambda m: m.init_decode_state(params, 1, FAM_PROMPT + 2 * NEW
                                              + 8)))
        del state, logits
        state, logits = self._lib_replay(
            "serve_vlm tokens", model, params, FAM_PROMPT,
            lambda t: {"tokens": torch.from_numpy(prompts[:1, t:t + 1]).to(
                self.dev)}, "bfloat16",
            {"tokens": torch.from_numpy(prompts[:1]).to(self.dev)},
            lambda m: m.init_decode_state(params, 1, FAM_PROMPT + NEW + 8))
        self._lib_time("serve_vlm", model, params, state, logits, w_bytes,
                       "profile_decode_vlm.txt")
        peak = torch.cuda.max_memory_allocated()
        log(f"serve_vlm: max_memory_allocated {peak / 2**30:.2f} GiB")
        if peak >= 80e9:
            raise AssertionError(f"serve_vlm: peak memory {peak} B")
        self.launches["serve_vlm"] = {"flash_attention": total}
        del params, state, logits
        torch.cuda.empty_cache()

    def serve_audio(self):
        """Phase 26: whisper-medium through the library (the serve driver
        refuses it, as the reference's does)."""
        import numpy as np
        import torch

        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data import make_embedding_file
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.models import encdec
        from repro_torch.serve import greedy_generate

        cfg, model, params, w_bytes = self._lib_model("whisper-medium")
        if (cfg.num_layers, cfg.encoder_layers, cfg.num_heads,
                cfg.resolved_head_dim, cfg.encoder_seq) != (
                    AUD_LAYERS, AUD_LAYERS, AUD_H, AUD_HD, AUD_FRAMES):
            raise AssertionError(f"whisper-medium: {cfg}")
        # The audio: frames written by make_embedding_file, read onto the
        # card through one CkIO session.
        path = os.path.join(self.tmp, "frames.bin")
        meta = make_embedding_file(path, AUD_FRAMES, cfg.d_model, seed=22)
        ck = CkIO(num_pes=2)
        fh = ck.open_sync(path, FileOptions(num_readers=4))
        off, nbytes = meta.byte_range_for_rows(0, AUD_FRAMES)
        t = time.perf_counter()
        sess = ck.start_read_session_sync(fh, nbytes, off)
        host = np.empty((AUD_FRAMES, cfg.d_model), dtype=np.float32)
        ck.read_sync(sess, nbytes, off, memoryview(host).cast("B"))
        ck.close_read_session_sync(sess)
        ck.close_sync(fh)
        frames = torch.from_numpy(host).to(self.dev)[None]
        torch.cuda.synchronize()
        want = np.fromfile(path, dtype=np.float32, offset=off).reshape(
            AUD_FRAMES, cfg.d_model)
        if not np.array_equal(host, want):
            raise AssertionError("serve_audio: frames differ from the file")
        log(f"serve_audio: {AUD_FRAMES} x {cfg.d_model} fp32 frames "
            f"({nbytes / 1e6:.2f} MB) read through one CkIO session onto the "
            f"card in {(time.perf_counter() - t) * 1e3:.1f} ms (host clock)")

        rng = np.random.default_rng(22)
        n_all = LIB_STATIC_REQUESTS + LIB_CONT_REQUESTS
        prompts = rng.integers(0, cfg.vocab_size, size=(n_all, FAM_PROMPT),
                               dtype=np.int32)
        count, paths = {}, []
        total = 0
        real_fa = FA.flash_attention_cuda

        def planned(q, k, v, **kw):
            if q.shape[2] == AUD_FRAMES:       # the encoder's Sq
                paths.append(FA.launch_plan(tuple(q.shape), tuple(k.shape),
                                            q.dtype)["path"])
            return real_fa(q, k, v, **kw)

        def run(mode, fn, enc_path="tensor_core"):
            nonlocal total
            torch.cuda.synchronize()
            FA.reset_launch_counts()
            count.clear()
            paths.clear()
            undo = [self._count(encdec, "decode_step", count),
                    self._count(encdec, "init_decode_state", count)]
            FA.flash_attention_cuda = planned
            t = time.perf_counter()
            try:
                out = fn()
                torch.cuda.synchronize()
            finally:
                FA.flash_attention_cuda = real_fa
                for u in undo:
                    u()
            wall = time.perf_counter() - t
            n = count.get("decode_step", 0)
            adm = count.get("init_decode_state", 0)
            got = FA.LAUNCHES["flash_attention"]
            want = 2 * AUD_LAYERS * n + AUD_LAYERS * adm
            if n == 0 or adm == 0 or got != want or paths != [
                    enc_path] * (AUD_LAYERS * adm):
                raise AssertionError(
                    f"serve_audio {mode}: flash_attention launched {got} "
                    f"times in {n} decode calls and {adm} admissions, not "
                    f"{2 * AUD_LAYERS} a call and {AUD_LAYERS} an admission;"
                    f" encoder paths {sorted(set(paths))}")
            log(f"serve_audio {mode}: {adm} admissions and {n} decode calls "
                f"in {wall:.2f} s (host clock); flash_attention {got} = "
                f"{2 * AUD_LAYERS} x {n} + {AUD_LAYERS} x {adm}, the "
                f"encoder's {len(paths)} on the {enc_path} path")
            total += got
            return out

        # Static: greedy_generate over the 4 prompts at B = 4, each with the
        # same audio.
        toks = run("static", lambda: greedy_generate(
            model, params, torch.from_numpy(prompts[:LIB_STATIC_REQUESTS]).to(
                self.dev), NEW,
            frames=frames.expand(LIB_STATIC_REQUESTS, -1, -1)))
        if toks.shape != (LIB_STATIC_REQUESTS, NEW) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"serve_audio static: tokens {toks.shape}")
        log(f"serve_audio static: greedy_generate(frames=) {LIB_STATIC_REQUESTS}"
            f" requests at B={LIB_STATIC_REQUESTS}, {toks.numel()} new tokens")
        run("continuous", lambda: self._lib_continuous(
            "serve_audio", model, params, prompts[LIB_STATIC_REQUESTS:],
            frames=frames))

        # An admission alone (the encoder and 24 layers' cross keys and
        # values), then the decode replay against forward_logits (plain
        # attention) over the same frames and prompt, bf16 and fp32.
        from torch.profiler import ProfilerActivity, profile

        with torch.no_grad():
            model.init_decode_state(params, 1, 8, frames=frames)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(4):
                model.init_decode_state(params, 1, 8, frames=frames)
            torch.cuda.synchronize()
            adm = (time.perf_counter() - t) / 4
            t = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    model.init_decode_state(params, 1, 8, frames=frames)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
        log(f"serve_audio: an admission (encoder over {AUD_FRAMES} frames, "
            f"{AUD_LAYERS} cross (k, v)) {adm * 1e3:.2f} ms (host clock, "
            f"synchronized)")
        busy = self._report_profile(prof, wall, 2, "admission",
                                    "profile_admission_audio.txt") / 2
        log(f"serve_audio: device time {busy * 1e3:.2f} ms an admission "
            f"(profiler) = {busy / adm:.3f} of the synchronized one")
        prompt = torch.from_numpy(prompts[:1]).to(self.dev)
        for dtype, enc_path in (("bfloat16", "tensor_core"),
                                ("float32", "cuda_core")):
            m = type(model)(cfg.replace(dtype=dtype))
            state, logits = run(f"replay {dtype}", lambda: self._lib_replay(
                "serve_audio", m, params, FAM_PROMPT,
                lambda t: {"tokens": prompt[:, t:t + 1]}, dtype,
                {"embeds": frames, "tokens": prompt},
                lambda m: m.init_decode_state(params, 1, FAM_PROMPT + NEW + 8,
                                              frames=frames)), enc_path)
            if dtype == "bfloat16":
                self._lib_time("serve_audio", m, params, state, logits,
                               w_bytes, "profile_decode_audio.txt")
        peak = torch.cuda.max_memory_allocated()
        log(f"serve_audio: max_memory_allocated {peak / 2**30:.2f} GiB")
        if peak >= 80e9:
            raise AssertionError(f"serve_audio: peak memory {peak} B")
        self.launches["serve_audio"] = {"flash_attention": total}
        del params, state, logits, frames
        torch.cuda.empty_cache()

    # -- 27 ----------------------------------------------------------------------
    # -- 27, 28 ----------------------------------------------------------------
    def sharded(self):
        """The constructor-sharded pipeline on a world-size-1 group over
        the card: (a) the main path trained from it, whole-window and
        streamed, against phase 4; (b) two ranks on the one card, each
        staging its block; (c) the staged-chunk ops over a real session's
        arrival-ordered splinters; (d) ``restore_sharded``. The group is
        destroyed before ``dryrun``, whose fake group is process-global."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.launch.sharding import NamedSharding, P

        if dist.is_initialized():
            raise AssertionError("sharded: a process group already exists")
        try:
            dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                    world_size=1)
            backend = "nccl"
        except Exception as e:      # noqa: BLE001  (said, then gloo)
            log(f"sharded: nccl refused a world-size-1 group ({e!r}); gloo")
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
            backend = "gloo"
        try:
            mesh = DeviceMesh(self.dev.type, torch.arange(1),
                              mesh_dim_names=("data",))
            sh = NamedSharding(mesh, P("data", None))
            log(f"sharded: {backend} group of 1, {mesh}, spec {sh.spec}, "
                f"placements {sh.placements}; {self.card_line}")
            t0 = time.perf_counter()
            params, cfg = self._sharded_train(sh)
            t1 = time.perf_counter()
            self._sharded_ranks()
            t2 = time.perf_counter()
            self._staged_ops()
            t3 = time.perf_counter()
            self._restore_sharded(params, cfg, mesh)
            t4 = time.perf_counter()
            log(f"sharded: {self.card_line}: (a) train {t1 - t0:.1f} s, (b) "
                f"two ranks {t2 - t1:.1f} s, (c) staged-chunk ops "
                f"{t3 - t2:.1f} s, (d) restore_sharded {t4 - t3:.1f} s")
        finally:
            dist.destroy_process_group()

    def _sharded_train(self, sh):
        """(a) ``STEPS`` main-path steps from a constructor-sharded pipeline
        per mode: local batches and losses bit-equal to phase 4's, the
        stage ledger balanced. Returns the last run's params."""
        import numpy as np
        import torch

        from repro_torch.kernels import reassemble as K

        window = STEPS * B * (S + 1) * 4
        for mode in ("window", "streamed"):
            cfg, path, _, params, opt, step_fn = self._trainer()
            pipe = self._pipeline(path, mode == "streamed", sharding=sh)
            losses, batches, t_steps, t_ingest = [], [], [], []
            K.reset_launch_counts()
            try:
                for step in range(STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    x, y = pipe.get_batch_device(step)
                    t_ingest.append(time.perf_counter() - t0)
                    if tuple(x.shape) != (B, S) or x.placements != tuple(
                            sh.placements):
                        raise AssertionError(f"sharded {mode}: DTensor "
                                             f"{x.shape} {x.placements}")
                    xl, yl = x.to_local(), y.to_local()
                    params, opt, m = step_fn(params, opt,
                                             {"tokens": xl, "labels": yl})
                    losses.append(float(m["loss"]))   # synchronizes
                    t_steps.append(time.perf_counter() - t0)
                    batches.append((xl.cpu().numpy(), yl.cpu().numpy()))
            finally:
                pipe.close()
            counts = dict(K.LAUNCHES)
            self.launches[f"sharded/{mode}"] = counts
            shards = pipe.ck.director.shards.summary()
            del opt
            for step, ((x, y), (xw, yw)) in enumerate(
                    zip(batches, self.batches["window"])):
                if not (np.array_equal(x, xw) and np.array_equal(y, yw)):
                    raise AssertionError(f"sharded {mode} step {step}: batch "
                                         f"differs from the window phase's")
            if losses != self.losses["window"]:
                raise AssertionError(f"sharded {mode}: losses {losses} vs the "
                                     f"window phase's {self.losses['window']}")
            puts = shards["device_put_calls"]
            if not (shards["window_bytes"] == shards["addressable_bytes"]
                    == window and shards["cross_host_bytes"] == 0
                    and shards["cross_host_placements"] == 0
                    and (puts == STEPS if mode == "window" else puts > STEPS)):
                raise AssertionError(f"sharded {mode}: ShardMetrics {shards}")
            if counts["reassemble_window"] != STEPS or K.TABLE_UPLOADS:
                raise AssertionError(f"sharded {mode}: launches {counts}, "
                                     f"{K.TABLE_UPLOADS} table uploads")
            steady = t_steps[1:] or t_steps
            step_s = sum(steady) / len(steady)
            ingest_s = sum(t_ingest[1:] or t_ingest) / len(steady)
            plain_in, plain_step = self.ingest_time[mode]
            log(f"sharded {mode}: losses bit-equal to the window phase's "
                f"{losses}; batches bit-equal; shards {json.dumps(shards)}; "
                f"launches {json.dumps(counts)}")
            log(f"sharded {mode}: {self.card_line}: get_batch_device "
                f"{ingest_s * 1e3:.3f} ms = {ingest_s / step_s * 100:.3f} % of "
                f"a {step_s * 1e3:.1f} ms step (host clock, steps 2-{STEPS}); "
                f"unsharded ({mode} phase) {plain_in * 1e3:.3f} ms = "
                f"{plain_in / plain_step * 100:.3f} % of {plain_step * 1e3:.1f}"
                f" ms")
            self.timing[f"sharded/{mode}"] = {"ingest_ms": ingest_s * 1e3,
                                             "step_ms": step_s * 1e3}
            if mode == "window":
                del params
                torch.cuda.empty_cache()
        return params, cfg

    def _sharded_ranks(self):
        """(b) Two ranks on the one card: two processes, a gloo group over a
        ``FileStore``, each reading ``RANK_STEPS`` steps whole-window and
        streamed through ``sharded_rank_main``."""
        import numpy as np

        from repro_torch.data.tokenfile import write_token_file

        d = os.path.join(self.tmp, "ranks")
        os.makedirs(d, exist_ok=True)
        # The corpus's first RANK_STEPS windows alone, so that no step past
        # them is prefetched and the stage ledger is exact.
        _, corpus = self._corpus()
        path = os.path.join(d, "corpus.bin")
        write_token_file(path, np.fromfile(corpus, dtype=np.uint32,
                                           offset=4096)[:RANK_STEPS * B * (S + 1)])
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank",
             str(r), "2", d, path, self.dev.type, str(B), str(S)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"sharded rank {r} exited "
                                     f"{p.returncode}:\n{out}")
        rows = B // 2
        span = RANK_STEPS * rows * (S + 1) * 4
        for mode in ("window", "streamed"):
            got = []
            for r in range(2):
                with open(os.path.join(d, f"rank{r}_{mode}.json")) as f:
                    rec = json.load(f)
                sm = rec["shards"]
                puts = sm["device_put_calls"]
                if not (sm["addressable_bytes"] == span
                        and sm["cross_host_bytes"] == span
                        and sm["window_bytes"] == 2 * span
                        and sm["devices_staged"] == 1
                        and sm["max_device_bytes"] == span
                        and (puts == RANK_STEPS if mode == "window"
                             else puts >= RANK_STEPS)):
                    raise AssertionError(f"sharded rank {r} {mode}: {sm}")
                if rec["launches"]["reassemble_window"] != RANK_STEPS:
                    raise AssertionError(f"sharded rank {r} {mode}: launches "
                                         f"{rec['launches']}")
                self.launches[f"sharded/rank{r}/{mode}"] = rec["launches"]
                got.append(np.load(os.path.join(d, f"rank{r}_{mode}.npz")))
                log(f"sharded rank {r} {mode}: shards {json.dumps(sm)}; "
                    f"get_batch_device {rec['ingest_ms']} ms")
            for step in range(RANK_STEPS):
                xw, yw = self.batches["window"][step]
                for r in range(2):
                    x, y = got[r][f"x{step}"], got[r][f"y{step}"]
                    if not (np.array_equal(x, xw[r * rows:(r + 1) * rows])
                            and np.array_equal(y, yw[r * rows:(r + 1) * rows])):
                        raise AssertionError(f"sharded rank {r} {mode} step "
                                             f"{step}: block differs")
                if not np.array_equal(np.concatenate(
                        [got[0][f"x{step}"], got[1][f"x{step}"]]), xw):
                    raise AssertionError(f"sharded {mode} step {step}: the "
                                         f"blocks do not tile the batch")
        log(f"sharded: two ranks on one card: each staged its {rows}-row "
            f"block ({span} B over {RANK_STEPS} steps) and counted the "
            f"other's {span} B cross-host; blocks tile the window phase's "
            f"batches, both modes")

    def _staged_ops(self):
        """(c) ``ops.ingest_chunks_block`` and ``ops.ingest_chunks_tokens``
        over a real session's splinters, staged on the card one chunk each
        in arrival order: bit-equal to their plain versions and to
        ``ops.reassemble_window`` over the file-order window."""
        import numpy as np
        import torch

        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data.packing import (
            as_block_permutation,
            pieces_in_arrival_order,
            token_gather_from_pieces,
        )
        from repro_torch.data.tokenfile import read_meta
        from repro_torch.kernels import ops
        from repro_torch.kernels import reassemble as K

        _, path = self._corpus()
        meta = read_meta(path)
        raw = np.fromfile(path, dtype=np.uint32, offset=4096).view(np.int32)
        need = B * (S + 1)
        ck = CkIO(num_pes=4, pes_per_node=4)
        f = ck.open_sync(path, FileOptions(num_readers=4,
                                           splinter_bytes=16 * 1024))
        try:
            off, nbytes = meta.byte_range_for_rows(0, need)
            sess = ck.start_read_session_sync(f, nbytes, off)
            ck.read_view_sync(sess, nbytes, off)
            pieces = pieces_in_arrival_order(sess.plan.splinters,
                                             ck.session_arrival_order(sess))
            host = [raw[(o - 4096) // 4:(o - 4096 + nb) // 4].copy()
                    for o, nb in pieces]
            ck.close_read_session_sync(sess)
        finally:
            ck.close_sync(f)
        chunks = [torch.from_numpy(c).to(self.dev) for c in host]
        cpu = [torch.from_numpy(c) for c in host]
        T = math.gcd(*[nb // 4 for _, nb in pieces],
                     *[(o - off) // 4 for o, _ in pieces])
        perm = as_block_permutation(token_gather_from_pieces(pieces, off, 4), T)
        row_idx = pieces_row_idx(pieces, off, B, S)
        file_order = ops.reassemble_window(
            torch.from_numpy(raw[:need]).to(self.dev), global_batch=B,
            seq_len=S)
        K.reset_launch_counts()
        block = ops.ingest_chunks_block(chunks, perm, global_batch=B, seq_len=S)
        tokens = ops.ingest_chunks_tokens(chunks, row_idx)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        self.launches["sharded/ops"] = counts
        if counts != {"reassemble_window": 1, "reassemble": 1,
                      "reassemble_tokens": 1}:
            raise AssertionError(f"staged-chunk ops: launches {counts}")
        plain_block = ops.ingest_chunks_block(cpu, perm, global_batch=B,
                                              seq_len=S)
        plain_tokens = ops.ingest_chunks_tokens(cpu, row_idx)
        self._same("reassemble", block,
                   tuple(t.to(self.dev) for t in plain_block))
        self._same("reassemble", block, file_order)
        self._same("reassemble_tokens", tokens,
                   tuple(t.to(self.dev) for t in plain_tokens))
        self._same("reassemble_tokens", tokens, file_order)
        log(f"staged-chunk ops: {len(pieces)} arrival-ordered chunks of a "
            f"session, blocks of {T} tokens; ingest_chunks_block and "
            f"ingest_chunks_tokens bit-equal to their plain versions and to "
            f"reassemble_window of the file-order window; launches "
            f"{json.dumps(counts)}")

    def _restore_sharded(self, params, cfg, mesh):
        """(d) The phase's params saved, then restored with
        ``restore_sharded`` onto ``param_specs`` over the 1-rank mesh: every
        leaf's local block bit-equal to ``restore_tree``'s, its placements
        the spec's."""
        import torch

        from repro_torch.launch.mesh import Mesh
        from repro_torch.launch.sharding import (
            param_specs,
            to_named,
            to_placements,
            tree_map,
        )
        from repro_torch.train import restore_sharded, restore_tree, save_checkpoint

        path = os.path.join(self.tmp, "sharded.ckpt")
        t0 = time.perf_counter()
        save_checkpoint(path, params, step=STEPS)
        t1 = time.perf_counter()
        specs = param_specs(params, Mesh(("data",), (1,)), cfg)
        plain, step = restore_tree(path, params)
        t2 = time.perf_counter()
        placed, step2 = restore_sharded(path, params, to_named(specs, mesh))
        t3 = time.perf_counter()
        if not step == step2 == STEPS:
            raise AssertionError(f"restore_sharded: steps {step}, {step2}")
        trio = []
        tree_map(lambda d, t, sp: trio.append((d, t, sp)), placed, plain,
                 specs)
        n = 0
        for d, t, sp in trio:
            pl = tuple(to_placements(sp, Mesh(("data",), (1,))))
            if d.placements != pl or d.shape != t.shape:
                raise AssertionError(f"restore_sharded: {d.placements} vs "
                                     f"{pl}, {d.shape} vs {t.shape}")
            if not torch.equal(d.to_local(), t):
                raise AssertionError("restore_sharded: a leaf differs from "
                                     "restore_tree's")
            n += 1
        nbytes = os.path.getsize(path)
        os.remove(path)
        log(f"restore_sharded: {n} leaves ({nbytes} B file) bit-equal to "
            f"restore_tree's, placements the spec's; {self.card_line}: save "
            f"{t1 - t0:.2f} s, restore_tree {t2 - t1:.2f} s, restore_sharded "
            f"{t3 - t2:.2f} s (host clock)")

    def examples(self):
        """``examples/torch_serve_lm.py`` at its preset on the card, in this
        process: recurrentgemma (reduced) decoding through the gated RG-LRU
        and flash-attention kernels."""
        import runpy

        import torch

        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import rglru_scan as LRU

        K = (FA, LRU)
        for mod in K:
            mod.reset_launch_counts()
        argv = sys.argv
        sys.argv = [os.path.join(ROOT, "examples", "torch_serve_lm.py"),
                    "--device", str(self.dev),
                    "--data", os.path.join(self.tmp, "serve_example.bin")]
        t0 = time.perf_counter()
        try:
            runpy.run_path(sys.argv[0], run_name="__main__")
        finally:
            sys.argv = argv
        torch.cuda.synchronize()
        counts = {}
        for mod in K:
            counts.update(mod.LAUNCHES)
        self.launches["examples/serve"] = counts
        if counts["flash_attention"] < 1 or counts["rglru_scan_gated"] < 1:
            raise AssertionError(f"examples: launches {counts}")
        log(f"examples: torch_serve_lm.py {time.perf_counter() - t0:.1f} s on "
            f"{torch.cuda.get_device_name(0)}; launches {json.dumps(counts)}")

    def _dryrun_card(self, name, run, rec, launched):
        """Run ``run()`` on the card under the dry run's FLOP counter with
        the flash-attention wrappers recording each launch's formula; hold
        the meta count (``rec``) to aten's count plus the formulas."""
        import torch

        from repro_torch.kernels import meta
        from repro_torch.kernels import ops
        from repro_torch.launch import dryrun as D

        fa = ops.FA.flash_attention_cuda
        train = ops.FA.flash_attention_train_cuda
        backward = ops.FA.flash_attention_backward_cuda

        def counted(qt, kt, vt, **kw):      # (B, H, S, hd), as ops passes them
            launched.append(meta.formula_flops(
                "flash_attention", (qt.shape[0], qt.shape[2], qt.shape[1],
                                    qt.shape[3]),
                (kt.shape[0], kt.shape[2], kt.shape[1], kt.shape[3]),
                (vt.shape[0], vt.shape[2], vt.shape[1], vt.shape[3])))
            return fa(qt, kt, vt, **kw)

        # The training entries: what the meta pass counts for the _sdpa it
        # runs in their place (its einsums, unmasked: two products forward,
        # four backward, of 2 B H Sq Sk hd FLOPs each).
        def dense(qt, kt):
            B, H, Sq, hd = qt.shape
            return 2 * B * H * Sq * kt.shape[2] * hd

        def counted_train(qt, kt, vt, **kw):
            launched.append(2 * dense(qt, kt))
            return train(qt, kt, vt, **kw)

        def counted_backward(dout, qt, kt, vt, out, lse, **kw):
            launched.append(4 * dense(qt, kt))
            return backward(dout, qt, kt, vt, out, lse, **kw)

        fc = D.flop_counter()
        ops.FA.flash_attention_cuda = counted
        ops.FA.flash_attention_train_cuda = counted_train
        ops.FA.flash_attention_backward_cuda = counted_backward
        try:
            with fc:
                run()
            torch.cuda.synchronize()
        finally:
            ops.FA.flash_attention_cuda = fa
            ops.FA.flash_attention_train_cuda = train
            ops.FA.flash_attention_backward_cuda = backward
        card = fc.get_total_flops()
        log(f"dryrun {name}: meta {rec['hlo_flops']:.0f} FLOPs; card aten "
            f"{card} + {len(launched)} kernel launches' formulas "
            f"{sum(launched)} = {card + sum(launched)}")
        if rec["hlo_flops"] != card + sum(launched):
            raise AssertionError(f"dryrun {name}: meta FLOPs "
                                 f"{rec['hlo_flops']} != card {card} + "
                                 f"kernels {sum(launched)}")

    def dryrun(self):
        import torch

        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun as D
        from repro_torch.launch import roofline as R
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import build_model

        mesh = make_host_mesh()
        if mesh.size != 1:
            raise AssertionError(f"dryrun: host mesh {mesh.axis_sizes}, one "
                                 f"card expected")
        # -- the window phase's train step ---------------------------------
        cfg, _ = self._corpus()
        cfg = cfg.replace(num_layers=ARCH_LAYERS)
        t0 = time.perf_counter()
        rec = D.run_cell(cfg.name, ShapeConfig("window", S, B, "train"),
                         mesh=mesh, cfg=cfg, num_microbatches=MICROBATCHES)
        log(f"dryrun train: meta passes {time.perf_counter() - t0:.1f} s; "
            f"record {json.dumps(rec)}")
        _, _, model, params, opt, step_fn = self._trainer()
        g = torch.Generator(device=self.dev).manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                  device=self.dev, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self._dryrun_card("train", lambda: step_fn(params, opt, batch), rec,
                          [])
        peak = torch.cuda.max_memory_allocated()
        want = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
        log(f"dryrun train: predicted argument + temp {want / 2**30:.3f} GiB "
            f"({rec['argument_size_in_bytes'] / 2**30:.3f} + "
            f"{rec['temp_size_in_bytes'] / 2**30:.3f}); the step's "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; ratio "
            f"{want / peak:.4f}")
        if abs(want - peak) > 0.25 * peak:
            raise AssertionError(f"dryrun train: predicted {want} B, card "
                                 f"peak {peak} B: more than 25 % apart")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_fn(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        del params, opt, step_fn, model
        torch.cuda.empty_cache()
        self._roofline_share("train", R.analyze_record(rec), times)
        # -- the serve phase's B=1 decode call -----------------------------
        cfg = cfg.replace(num_layers=32)
        shape = ShapeConfig("serve", PROMPT + NEW, 1, "decode")
        t0 = time.perf_counter()
        rec = D.run_cell(cfg.name, shape, mesh=mesh, cfg=cfg)
        log(f"dryrun decode: meta passes {time.perf_counter() - t0:.1f} s; "
            f"record {json.dumps(rec)}")
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        state = model.init_decode_state(params, 1, PROMPT + NEW)
        state = state._replace(pos=PROMPT + NEW - 1)      # the last new token
        tok = {"tokens": torch.zeros((1, 1), dtype=torch.int32,
                                     device=self.dev)}
        launched = []
        with torch.no_grad():
            self._dryrun_card("decode", lambda: model.decode(params, state, tok),
                              rec, launched)
            if len(launched) != cfg.num_layers:
                raise AssertionError(f"dryrun decode: {len(launched)} "
                                     f"flash-attention launches, not "
                                     f"{cfg.num_layers}")
            times = []
            for _ in range(NEW):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model.decode(params, state, tok)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
        del params, state
        torch.cuda.empty_cache()
        self._roofline_share("decode", R.analyze_record(rec), times)
        # -- the SSM and hybrid train steps: memory --------------------------
        for arch, layers, impl in (
                ("falcon-mamba-7b", SSM_TRAIN_LAYERS, "materialized"),
                ("falcon-mamba-7b", SSM_TRAIN_LAYERS, "fused"),
                ("recurrentgemma-2b", HYB_TRAIN_LAYERS, None)):
            self._dryrun_train_memory(mesh, arch, layers, impl)

    def _dryrun_train_memory(self, mesh, arch, layers, impl):
        """The dry run's per-device argument + temp bytes of a train step
        of ``arch`` at ``layers`` layers (the window phase's batch) against
        the same step's ``max_memory_allocated`` on the card: within 25 %.
        The step's scans save their inputs in the meta ops and in the
        autograd Functions alike, and recompute the states."""
        import torch

        from repro_torch.configs.base import ShapeConfig
        from repro_torch.configs.registry import get_config
        from repro_torch.launch import dryrun as D
        from repro_torch.models import build_model
        from repro_torch.train import OptConfig, init_opt_state, make_train_step

        cfg = get_config(arch).replace(num_layers=layers)
        if impl:
            cfg = cfg.replace(ssm_impl=impl)
        name = f"{arch}{f' {impl}' if impl else ''} train"
        t0 = time.perf_counter()
        rec = D.run_cell(cfg.name, ShapeConfig("window", S, B, "train"),
                         mesh=mesh, cfg=cfg, num_microbatches=MICROBATCHES)
        log(f"dryrun {name}: meta passes {time.perf_counter() - t0:.1f} s; "
            f"record {json.dumps(rec)}")
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        opt = init_opt_state(params)
        step_fn = make_train_step(
            model, OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=STEPS),
            num_microbatches=MICROBATCHES)
        g = torch.Generator(device=self.dev).manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                  device=self.dev, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del params, opt, step_fn, model, batch
        torch.cuda.empty_cache()
        want = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
        log(f"dryrun {name}: predicted argument + temp {want / 2**30:.3f} GiB "
            f"({rec['argument_size_in_bytes'] / 2**30:.3f} + "
            f"{rec['temp_size_in_bytes'] / 2**30:.3f}); the step's "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; ratio "
            f"{want / peak:.4f}")
        self.timing[f"dryrun/{name}"] = {"ratio": want / peak}
        if abs(want - peak) > 0.25 * peak:
            raise AssertionError(f"dryrun {name}: predicted {want} B, card "
                                 f"peak {peak} B: more than 25 % apart")

    def _roofline_share(self, name, roof, times):
        """The roofline's ``step_s`` against the measured time (host clock
        around a synchronized call; the first call left out)."""
        steady = times[1:] or times
        t = sum(steady) / len(steady)
        log(f"dryrun {name}: {self.card_line}: measured {t * 1e3:.3f} ms "
            f"(mean of {len(steady)}); roofline step_s {roof.step_s * 1e3:.4f}"
            f" ms (compute {roof.compute_s * 1e3:.4f}, memory "
            f"{roof.memory_s * 1e3:.4f}, collective "
            f"{roof.collective_s * 1e3:.4f}; {roof.dominant}-bound); share "
            f"{roof.step_s / t:.4f} of the roofline, compute share "
            f"{roof.compute_s / t:.4f}")
        self.timing[f"dryrun/{name}"] = {"ms": t * 1e3,
                                        "step_s": roof.step_s}

    # -- 31, 32: the backward kernels and the SSM and hybrid train steps ------
    def _grads_close(self, name, got, want, tol, scale=False):
        """Each gradient of ``got`` within ``tol`` of ``want``'s (None where
        the input had none): elementwise (``_close``), or with ``scale``
        within ``tol`` of the gradient's largest magnitude, the rule for
        bf16 gradients. A bf16 gradient such as ``dxin = dyp * Dskip +
        dx.to(bf16)`` adds operands rounded to bf16 from fp32 sums that the
        kernel and the plain backward take in other orders: where the two
        sums straddle a rounding boundary the operands differ by a bf16
        step, which a cancelling sum keeps whole beside a small result."""
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            if (g is None) != (w is None):
                raise AssertionError(f"{name}: a gradient is None on one "
                                     f"side only")
            if w is None:
                continue
            if not scale:
                self._close(name, g, w, tol)
                continue
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                     f"{w.shape}/{w.dtype}")
            err = (g.float() - w.float()).abs().max().item() if g.numel() \
                else 0.0
            top = w.float().abs().max().item() if w.numel() else 0.0
            self.err[name] = max(self.err[name], err)
            if err > tol * top:
                raise AssertionError(f"{name}: gradient {i} differs from the "
                                     f"plain version by {err}, beyond {tol} "
                                     f"of its largest magnitude {top}")

    @staticmethod
    def _same_bits(name, a, b):
        import torch

        if not all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(a, b, strict=True)):
            raise AssertionError(f"{name}: two runs on the same inputs give "
                                 f"other bits")

    def _bwd_time(self, name, r, kernel, plain):
        """The kernel's and the plain backward's device time at the
        microbatch shape (CUDA events behind the spin kernel, in turns),
        and the device time of the entry's own kernels alone
        (``kernels_alone_ms``), which leaves out the torch ops around
        them."""
        times = alternate({"kernel": kernel, "plain": plain}, 5, 1, 1)
        r["ms"], r["plain_ms"] = times["kernel"], times["plain"]
        r["library_ms"] = None   # no PyTorch call computes a scan's gradient
        r["kernels_alone_ms"], r["by_kernel_ms"] = kernels_alone_ms(kernel)
        self.timing[f"{name}/train"] = r
        log(f"time {name}/train: {self.card_line}: {json.dumps(r)}")

    def _bwd_literal(self):
        """``scan_bwd_cluster_kernel`` against ``ref.ssm_scan_bwd_ref``
        (1e-4): S = 1, 17 and 2048 with and without h0; the plan's edges
        (``MS.scan_bwd_plan``): a chunk less one and one more at the train
        length, a window of 16 chunks of 256 steps and one more step, three
        windows, every state size by TMA copies and a state a
        thread, D * N off the block's states, with and without h0 in turn;
        and a microbatch of the train
        step (B=2, S=2048, D=8192, N=16: 2^29 elements an input); twice on
        the same inputs for the same bits; timed at the microbatch shape,
        with the plan and the clusters the card runs at once."""
        import torch

        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ref

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(8)
        cases = [(None, b, s, d, SSM_N, h) for b, s, d in (
            (1, 1, 64), (2, 17, 520), (1, S, 256)) for h in (False, True)]
        cases += [("edge", b, s, d, n, i % 2 == 1) for i, (b, s, d, n) in
                  enumerate(((2, S - 1, 40, SSM_N), (2, S + 1, 40, SSM_N),
                             (1, 4096, 5, SSM_N), (1, 4097, 5, SSM_N),
                             (1, 8193, 5, SSM_N),
                             (2, 300, 37, 1), (2, 300, 37, 2),
                             (2, 300, 44, 4), (2, 300, 44, 8),
                             (2, 300, 44, 32)))]
        cases.append(("train", MB, S, SSM_D, SSM_N, False))
        for key, b, s, d, n, with_h0 in cases:
            A = torch.randn((b, s, d, n), device=dev, generator=g).sigmoid_()
            Bx = torch.randn((b, s, d, n), device=dev, generator=g).mul_(0.1)
            C = torch.randn((b, s, n), device=dev, generator=g)
            h0 = (torch.randn((b, d, n), device=dev, generator=g).mul_(0.5)
                  if with_h0 else None)
            gy = torch.randn((b, s, d), device=dev, generator=g)
            got = MS.mamba_scan_backward_cuda(gy, A, Bx, C, h0)
            self._grads_close("mamba_scan_backward", got,
                              ref.ssm_scan_bwd_ref(gy, A, Bx, C, h0), 1e-4)
            self._same_bits("mamba_scan_backward", got,
                            MS.mamba_scan_backward_cuda(gy, A, Bx, C, h0))
            torch.cuda.synchronize()
            plan = MS.scan_bwd_plan(b, s, d, n)
            log(f"scan backward: B={b} S={s} D={d} N={n}"
                f"{' h0' if with_h0 else ''} (chunks of {plan['chunk']}, "
                f"{plan['states']} states a block, {plan['windows']} "
                f"window(s)): within 1e-4 of the plain backward, the same "
                f"bits twice; max abs err so far "
                f"{self.err['mamba_scan_backward']}")
            if key == "train":
                # gy, Abar, Bx, C read once; dAbar, dBx, dC written once.
                # FLOPs: the state's FMA, g's FMA, dAbar's product and dC's
                # product and sum a state element.
                nbytes = 4 * (4 * b * s * d * n + b * s * d + 2 * b * s * n)
                flops = 8 * b * s * d * n
                b_bytes, b_ops = bound_ms(nbytes), flops / FP32_PEAK * 1e3
                self._bwd_time("mamba_scan_backward", {
                    "shape": f"B={b} S={s} D={d} N={n} fp32",
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": max(b_bytes, b_ops),
                    "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                    "plan": {k: plan[k] for k in (
                        "cluster", "chunk", "states", "threads", "windows",
                        "smem", "elem_bytes")},
                    "clusters": MS.scan_bwd_clusters(plan, n)},
                    lambda: MS.mamba_scan_backward_cuda(gy, A, Bx, C, h0),
                    lambda: ref.ssm_scan_bwd_ref(gy, A, Bx, C, h0))
            del A, Bx, C, h0, gy, got
            torch.cuda.empty_cache()

    def _bwd_fused(self):
        """``mamba_scan_fused_backward_cuda`` (the chunked kernels) against
        ``ref.mamba_scan_fused_bwd_ref``: fp32 at 1e-4 and bf16 at 2e-2 of
        each gradient's largest magnitude (``_grads_close``), S = 1, 17 and
        2048 with and without h0, ``z`` a view of a (B, S, 2D) product and
        ``proj`` a column slice of a wider one (rows not 16-byte aligned),
        ragged D and odd r; the chunk edges (S = 63, 64, 65 and two chunks
        and a ragged sub-segment, B=2, D past one block, xin
        channel-major); a microbatch of the train step in bf16 with xin
        channel-major as the conv leaves it; twice for the same bits; timed
        there, the kernels alone beside the whole function."""
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import ref

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(9)

        def inputs(b, s, d, n, r, dtype, with_h0, channel_major=False):
            rnd = lambda *shape: torch.randn(  # noqa: E731
                shape, device=dev, generator=g)
            A = torch.arange(1, n + 1, device=dev, dtype=torch.float32)
            t = dict(
                xin=(F.silu(rnd(b, d, s)).transpose(1, 2) if channel_major
                     else F.silu(rnd(b, s, d))).to(dtype),
                dt_pre=rnd(b, s, d).mul_(0.5).to(dtype),
                dt_bias=rnd(d).mul_(0.1).add_(math.log(math.expm1(1e-2))),
                A_log=torch.log(A).repeat(d, 1).add_(rnd(d, n).mul_(0.1)),
                proj=rnd(b, s, r + 2 * n + 3).to(dtype)[..., :r + 2 * n],
                Dskip=rnd(d).mul_(0.1).add_(1.0),
                z=rnd(b, s, 2 * d).to(dtype)[..., d:])
            h0 = rnd(b, d, n).mul_(0.5) if with_h0 else None
            return tuple(t.values()), h0, rnd(b, s, d).to(dtype)

        bf16, fp32 = torch.bfloat16, torch.float32
        cases = [(None, b, s, d, SSM_N, r, dt, h)
                 for b, s, d, r in ((1, 1, 256, 256), (2, 17, 100, 5),
                                    (1, S, 256, 256))
                 for dt in (fp32, bf16) for h in (False, True)]
        cases += [("edge", 2, s, 130, SSM_N, 5, dt, h)
                  for s in (63, 64, 65, 157) for dt in (fp32, bf16)
                  for h in (False, True)]
        cases.append(("train", MB, S, SSM_D, SSM_N, 256, bf16, False))
        for key, b, s, d, n, r, dtype, with_h0 in cases:
            args, h0, gy = inputs(b, s, d, n, r, dtype, with_h0,
                                  channel_major=key is not None)
            tol = 1e-4 if dtype == fp32 else 2e-2
            got = MS.mamba_scan_fused_backward_cuda(gy, *args, h0)
            self._grads_close("mamba_scan_fused_backward", got,
                              ref.mamba_scan_fused_bwd_ref(gy, *args, h0), tol,
                              scale=dtype == bf16)
            self._same_bits("mamba_scan_fused_backward", got,
                            MS.mamba_scan_fused_backward_cuda(gy, *args, h0))
            torch.cuda.synchronize()
            log(f"fused scan backward: B={b} S={s} D={d} N={n} r={r} {dtype}"
                f"{' h0' if with_h0 else ''}: within {tol} of the plain "
                f"backward, the same bits twice; max abs err so far "
                f"{self.err['mamba_scan_fused_backward']}")
            if key == "train":
                # gy, xin, dt_pre, z read and dxin, ddt_pre, dz written
                # once (B, S, D); proj read and dproj written; the params
                # and their gradients. Special-function results: Abar's ex2
                # a state element, softplus's and silu's a (b, t, d).
                e = gy.element_size()
                nbytes = (e * (7 * b * s * d + 2 * b * s * (r + 2 * n))
                          + 8 * (2 * d + d * n))
                self._bwd_time("mamba_scan_fused_backward", {
                    "shape": f"B={b} S={s} D={d} N={n} r={r} {dtype}",
                    **self._two_sided(nbytes, b * s * d * n + 4 * b * s * d)},
                    lambda: MS.mamba_scan_fused_backward_cuda(gy, *args, h0),
                    lambda: ref.mamba_scan_fused_bwd_ref(gy, *args, h0))
            del args, h0, gy, got
            torch.cuda.empty_cache()

    def _bwd_lru(self):
        """``lru_bwd_kernel`` against ``ref.rglru_scan_gated_bwd_ref``: fp32
        at 1e-5 and bf16 at 2e-2 of each gradient's largest magnitude, S =
        1, 17 and 2048 with and without h0, and the chunk and segment edges
        (S = 7, 8, 9, 128, 129 and two segments and a ragged tail, B=2), xr
        channel-major (the conv's layout) and ``gate`` a view; a microbatch
        of the train step (B=2, S=2048, W=2560) in bf16; twice for the same
        bits; timed there, the kernels alone beside the whole function."""
        import torch
        import torch.nn.functional as F

        from repro_torch.kernels import ref
        from repro_torch.kernels import rglru_scan as LRU

        dev = self.dev
        g = torch.Generator(device=dev)
        g.manual_seed(10)

        def inputs(b, s, w, dtype, with_h0):
            rnd = lambda *shape: torch.randn(  # noqa: E731
                shape, device=dev, generator=g)
            lam = torch.log(torch.expm1(-torch.log(torch.linspace(
                0.9, 0.999, w, device=dev)) / 8.0))
            args = (rnd(b, s, w), rnd(b, s, w), rnd(w).mul_(0.1),
                    rnd(w).mul_(0.1), lam,
                    rnd(b, w, s).to(dtype).transpose(1, 2),
                    F.gelu(rnd(b, s, 2 * w), approximate="tanh").to(
                        dtype)[..., w:])
            h0 = rnd(b, w).mul_(0.5) if with_h0 else None
            return args, h0, rnd(b, s, w).to(dtype)

        bf16, fp32 = torch.bfloat16, torch.float32
        cases = [(None, b, s, w, dt, h)
                 for b, s, w in ((1, 1, RG_W), (2, 17, 300), (1, S, 300),
                                 (2, 7, 300), (2, 8, 300), (2, 9, 300),
                                 (2, 128, 300), (2, 129, 300), (2, 293, 300))
                 for dt in (fp32, bf16) for h in (False, True)]
        cases.append(("train", MB, S, RG_W, bf16, False))
        for key, b, s, w, dtype, with_h0 in cases:
            args, h0, gy = inputs(b, s, w, dtype, with_h0)
            tol = 1e-5 if dtype == fp32 else 2e-2
            got = LRU.rglru_scan_gated_backward_cuda(gy, *args, h0)
            self._grads_close("rglru_scan_gated_backward", got,
                              ref.rglru_scan_gated_bwd_ref(gy, *args, h0), tol,
                              scale=dtype == bf16)
            self._same_bits("rglru_scan_gated_backward", got,
                            LRU.rglru_scan_gated_backward_cuda(gy, *args, h0))
            torch.cuda.synchronize()
            log(f"lru backward: B={b} S={s} W={w} {dtype}"
                f"{' h0' if with_h0 else ''}: within {tol} of the plain "
                f"backward, the same bits twice; max abs err so far "
                f"{self.err['rglru_scan_gated_backward']}")
            if key is not None:
                # r_pre, i_pre read and their gradients written (fp32); gy,
                # xr, gate read and dxr, dgate written (compute dtype).
                # Special-function results an element: two sigmoids (ex2,
                # rcp), a, exp(2 log_a), sqrt, the division.
                e = gy.element_size()
                nbytes = (16 + 5 * e) * b * s * w + 24 * w
                self._bwd_time("rglru_scan_gated_backward", {
                    "shape": f"B={b} S={s} W={w} {dtype}",
                    **self._two_sided(nbytes, 8 * b * s * w)},
                    lambda: LRU.rglru_scan_gated_backward_cuda(gy, *args, h0),
                    lambda: ref.rglru_scan_gated_bwd_ref(gy, *args, h0))
            del args, h0, gy, got
            torch.cuda.empty_cache()

    def _train_driver(self, name, arch, layers, impl, expect):
        """``launch.train.main`` at full width with ``layers`` layers, the
        window phase's batch, microbatches and steps, checkpoints off,
        ``ssm_impl`` set to ``impl`` when given. The launch counts are zeroed
        just before the run and read after it: ``expect`` maps each kernel
        to its launches; no function of ``kernels/ref.py`` may be called.
        Records the losses (finite), each step's time (host clock around a
        synchronized step), tokens/s, peak device memory, and the third
        step's device time by kernel under ``torch.profiler``."""
        import contextlib
        import io

        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import reassemble as K
        from repro_torch.kernels import ref
        from repro_torch.kernels import rglru_scan as LRU
        from repro_torch.launch import train as T

        class NoSave(T.AsyncCheckpointer):
            def save(self, tree, step, **kw):
                return None

        rec = {"losses": [], "step_s": []}
        ref_calls = {}
        undo = [self._count(ref, fn, ref_calls) for fn in dir(ref)
                if not fn.startswith("_")
                and callable(getattr(ref, fn))
                and getattr(getattr(ref, fn), "__module__", "") == ref.__name__]
        make_train_step, get_config = T.make_train_step, T.get_config
        checkpointer = T.AsyncCheckpointer

        def recorded_step(*a, **kw):
            inner = make_train_step(*a, **kw)

            def step_fn(params, opt, batch):
                prof = None
                if len(rec["losses"]) == 2:        # the third step
                    prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, m = inner(params, opt, batch)
                rec["losses"].append(float(m["loss"]))  # synchronizes
                rec["step_s"].append(time.perf_counter() - t0)
                if prof is not None:
                    prof.__exit__(None, None, None)
                    rec["by_kernel"] = sorted(
                        ((e.self_device_time_total, e.key, e.count)
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and e.self_device_time_total > 0), reverse=True)
                return p, o, m
            return step_fn

        def impl_config(arch_name):
            cfg = get_config(arch_name)
            return cfg.replace(ssm_impl=impl) if impl else cfg

        argv = ["--arch", arch, "--layers", str(layers), "--steps", str(STEPS),
                "--global-batch", str(B), "--seq", str(S), "--microbatches",
                str(MICROBATCHES), "--lr", "1e-3", "--num-readers", "4",
                "--num-consumers", "16", "--device-ingest", "--data",
                os.path.join(self.tmp, f"corpus_{arch}.bin"), "--ckpt-every",
                "1000", "--ckpt-dir", os.path.join(self.tmp, f"ck_{name}")]
        T.make_train_step, T.get_config = recorded_step, impl_config
        T.AsyncCheckpointer = NoSave
        out = io.StringIO()
        for mod in (K, FA, MS, LRU):
            mod.reset_launch_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                summary = T.main(argv)
        finally:
            T.make_train_step, T.get_config = make_train_step, get_config
            T.AsyncCheckpointer = checkpointer
            for u in undo:
                u()
        wall = time.perf_counter() - t0
        counts = {k: v for mod in (K, FA, MS, LRU)
                  for k, v in mod.LAUNCHES.items()}
        self.launches[name] = counts
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        steady = rec["step_s"][1:2] + rec["step_s"][3:]   # not the profiled
        step_s = sum(steady) / len(steady)
        rows = rec.get("by_kernel", [])
        busy = sum(r[0] for r in rows) / 1e6
        bwd = sum(r[0] for r in rows if any(
            k in r[1] for k in BWD_DEVICE_KERNELS)) / 1e6
        for line in out.getvalue().splitlines()[:1]:
            log(f"{name}: {line}")
        log(f"{name}: {' '.join(argv)}{f' (ssm_impl {impl})' if impl else ''}"
            f"; {self.card_line}; {wall:.1f} s (host clock); losses "
            f"{rec['losses']}; step times {rec['step_s']} s; mean of steps "
            f"2 and 4 {step_s * 1e3:.1f} ms = {B * S / step_s:.0f} tokens/s; "
            f"peak device memory {peak / 2**30:.2f} GiB; launches "
            f"{json.dumps(counts)}; calls into kernels/ref.py "
            f"{json.dumps(ref_calls)}")
        if rows:
            log(f"{name}: the profiled step's device time {busy * 1e3:.1f} ms,"
                f" backward kernels {bwd * 1e3:.2f} ms = {bwd / busy:.4f} "
                f"of it")
            for dev_us, key, count in rows[:8]:
                log(f"{name}: {dev_us / 1e3:9.3f} ms {count:6d} calls "
                    f"{key[:90]}")
        else:
            log(f"{name}: the profiler recorded no device time (not "
                f"measured)")
        self.timing[name] = {"step_ms": step_s * 1e3,
                             "tokens_per_s": B * S / step_s,
                             "peak_gib": peak / 2**30,
                             "bwd_share": bwd / busy if rows else None}
        if summary["steps"] != STEPS or len(rec["losses"]) != STEPS or not all(
                math.isfinite(x) for x in rec["losses"]):
            raise AssertionError(f"{name}: summary {summary['steps']} steps, "
                                 f"losses {rec['losses']}")
        if ref_calls:
            raise AssertionError(f"{name}: the card's path called "
                                 f"kernels/ref.py: {ref_calls}")
        wrong = {k: (counts.get(k), n) for k, n in expect.items()
                 if counts.get(k) != n}
        if wrong:
            raise AssertionError(f"{name}: launches (got, want) {wrong}")
        if peak > 80e9:
            raise AssertionError(f"{name}: peak {peak} B past one card")

    def train_ssm(self):
        """falcon-mamba-7b trained on the card: its two backward kernels
        held against their plain backwards, then the train driver at 4
        layers for 4 steps in each ``ssm_impl``: one backward launch a
        Mamba layer a microbatch, the forward kernel twice (the block's
        activation checkpoint recomputes it), the other impl's kernels 0."""
        self._bwd_literal()
        self._bwd_fused()
        n = SSM_TRAIN_LAYERS * MICROBATCHES * STEPS
        self._train_driver("train_ssm_materialized", "falcon-mamba-7b",
                           SSM_TRAIN_LAYERS, "materialized",
                           {"mamba_scan_backward": n, "mamba_scan": 2 * n,
                            "mamba_scan_fused": 0,
                            "mamba_scan_fused_backward": 0,
                            "reassemble_window": STEPS})
        self._train_driver("train_ssm_fused", "falcon-mamba-7b",
                           SSM_TRAIN_LAYERS, "fused",
                           {"mamba_scan_fused_backward": n,
                            "mamba_scan_fused": 2 * n, "mamba_scan": 0,
                            "mamba_scan_backward": 0,
                            "reassemble_window": STEPS})

    def train_hybrid(self):
        """recurrentgemma-2b trained on the card: the gated RG-LRU backward
        kernel held against its plain backward, then the train driver at 6
        layers (4 RG-LRU, 2 local attention) for 4 steps: one backward
        launch an RG-LRU layer a microbatch, the literal kernel and flash
        attention never (the loss differentiates the plain attention)."""
        self._bwd_lru()
        n = (HYB_TRAIN_LAYERS * 2 // 3) * MICROBATCHES * STEPS
        self._train_driver("train_hybrid", "recurrentgemma-2b",
                           HYB_TRAIN_LAYERS, None,
                           {"rglru_scan_gated_backward": n,
                            "rglru_scan_gated": 2 * n, "rglru_scan": 0,
                            "flash_attention": 0,
                            "reassemble_window": STEPS})

    # -- 33 --------------------------------------------------------------------
    def layer_kinds(self):
        """A smoke-width model holding all twelve (mixer, FFN) kinds, its
        attention logits capped at KINDS_CAP, in fp32: one train step on the
        card against the same step on the CPU (params at KINDS_PARAM_TOL
        relative L2; the card's backward runs the literal Mamba and gated
        RG-LRU backward kernels once a layer of theirs, three each), then a
        KINDS_REPLAY-token replay
        through decode on the card (the capped split-key decode kernel on
        every attention layer, rings wrapped) against its prefill forward
        at capacity factor E/k (PERF.md's 1e-4 relative L2)."""
        import torch

        from repro_torch.configs.base import (ATTN, ATTN_LOCAL, DENSE, MAMBA,
                                              MOE, NONE, RGLRU, LayerSpec)
        from repro_torch.configs.registry import get_config, smoke_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import mamba_scan as MS
        from repro_torch.kernels import rglru_scan as LRU
        from repro_torch.launch.sharding import tree_map
        from repro_torch.models import build_model
        from repro_torch.models.transformer import forward_logits
        from repro_torch.train import (OptConfig, init_opt_state, leaves,
                                       make_train_step)

        kinds = tuple(LayerSpec(m, f, 16 if m == ATTN_LOCAL else 0)
                      for m in (ATTN, ATTN_LOCAL, MAMBA, RGLRU)
                      for f in (DENSE, MOE, NONE))
        cfg = smoke_config(get_config("qwen2-moe-a2.7b")).replace(
            block_pattern=kinds, num_layers=len(kinds), dtype="float32",
            d_inner=128, ssm_state=4, dt_rank=8, lru_width=64, window=16,
            attn_logit_softcap=KINDS_CAP)
        model = build_model(cfg)
        g = torch.Generator().manual_seed(11)
        toks = torch.randint(0, cfg.vocab_size, (2, KINDS_SEQ + 1),
                             generator=g, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=STEPS)
        out = {}
        for dev in ("cpu", self.dev):
            # The same numbers on both devices: drawn on the CPU.
            params = tree_map(lambda t: t.to(dev), model.init(0, device="cpu"))
            for mod in (MS, LRU, FA):
                mod.reset_launch_counts()
            step = make_train_step(model, opt_cfg)
            p, _, m = step(params, init_opt_state(params),
                           {k: v.to(dev) for k, v in batch.items()})
            out[str(dev)] = (torch.cat([t.detach().float().flatten().cpu()
                                        for t in leaves(p)]),
                             float(m["loss"]))
            counts = {**MS.LAUNCHES, **LRU.LAUNCHES, **FA.LAUNCHES}
        self.launches["layer_kinds_step"] = counts
        (cpu, lc), (card, lg) = out["cpu"], out[str(self.dev)]
        rel = float((card - cpu).norm() / cpu.norm())
        log(f"layer_kinds: one train step of 12 layers, one of each kind "
            f"(softcap {KINDS_CAP}): loss card {lg} / CPU {lc}; params "
            f"relative L2 card vs CPU {rel:.3e}; the card step's launches "
            f"{json.dumps(counts)}")
        if rel > KINDS_PARAM_TOL:
            raise AssertionError(f"layer_kinds: params {rel} apart")
        if counts["mamba_scan_backward"] != 3 or counts[
                "rglru_scan_gated_backward"] != 3:
            raise AssertionError(f"layer_kinds: backward launches {counts}")
        # The replay: decode token by token against the prefill forward.
        cfg = self._dropless(cfg, KINDS_REPLAY)
        model = build_model(cfg)
        params = model.init(0, device=self.dev)
        prompt = toks[:, :KINDS_REPLAY].to(self.dev)
        FA.reset_launch_counts()
        with torch.no_grad():
            want = forward_logits(params, cfg, {"tokens": prompt},
                                  last_only=False)
            state = model.init_decode_state(params, 2, KINDS_REPLAY)
            got = []
            for t in range(KINDS_REPLAY):
                lg_, state = model.decode(params, state,
                                          {"tokens": prompt[:, t:t + 1]})
                got.append(lg_)
            got = torch.cat(got, dim=1)
        torch.cuda.synchronize()
        rel = float((got - want).float().norm() / want.float().norm())
        fa = FA.LAUNCHES["flash_attention"]
        log(f"layer_kinds: {KINDS_REPLAY}-token replay through decode "
            f"(16-slot local rings wrapped) against the prefill forward: "
            f"relative L2 {rel:.3e}; {fa} flash-attention launches "
            f"(6 attention layers a step)")
        if rel > PREFILL_REL_TOL["float32"] or not torch.isfinite(got).all():
            raise AssertionError(f"layer_kinds: replay {rel} from prefill")
        if fa != 6 * KINDS_REPLAY:
            raise AssertionError(f"layer_kinds: {fa} attention launches")

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
                    "rglru_scan_gated": "rglru_scan_gated/decode",
                    **{k: f"{k}/train" for k in BWD_KERNELS + ATTN_TRAIN}}
        out = []
        for name, key in main_key.items():
            r = self.timing[key]
            out.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches.get(name, 0),
                "max_abs_err": self.err[name], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r.get("bound_by", "bytes"),
                "library_ms": r["library_ms"],
                **({"fuses": FUSES[name]} if name in FUSES else {}),
            })
        return {"kernels": out}


def sharded_rank_main(rank: int, world: int, d: str, path: str,
                      device_type: str, b: int, s: int) -> None:
    """One rank of the sharded phase's two-rank check, in a process of its
    own: a gloo group over a ``FileStore`` in ``d``, a ``("data",)`` mesh of
    ``world`` ranks (all on ``cuda:0`` for ``device_type`` cuda), and
    ``RANK_STEPS`` steps of ``(b, s)`` batches of the corpus at ``path``
    through a constructor-sharded pipeline, whole-window and streamed. Writes each
    mode's local blocks (``rank{r}_{mode}.npz``) and its ``ShardMetrics``,
    launches and ``get_batch_device`` times (``rank{r}_{mode}.json``)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import CkIO, FileOptions
    from repro_torch.data import CkIOPipeline
    from repro_torch.kernels import reassemble as K
    from repro_torch.launch.sharding import NamedSharding, P

    dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device(
        "cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, "store"), world),
        rank=rank, world_size=world)
    try:
        mesh = DeviceMesh(device_type, torch.arange(world),
                          mesh_dim_names=("data",))
        sh = NamedSharding(mesh, P("data", None))
        for mode in ("window", "streamed"):
            pipe = CkIOPipeline(
                path, b, s, ckio=CkIO(num_pes=4, pes_per_node=4),
                num_consumers=16, file_opts=FileOptions(num_readers=4),
                streaming=mode == "streamed", sharding=sh, device=dev)
            K.reset_launch_counts()
            out, ms = {}, []
            try:
                for step in range(RANK_STEPS):
                    t0 = time.perf_counter()
                    x, y = pipe.get_batch_device(step)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    out[f"x{step}"] = x.to_local().cpu().numpy()
                    out[f"y{step}"] = y.to_local().cpu().numpy()
            finally:
                pipe.close()
            np.savez(os.path.join(d, f"rank{rank}_{mode}.npz"), **out)
            with open(os.path.join(d, f"rank{rank}_{mode}.json"), "w") as f:
                json.dump({"shards": pipe.ck.director.shards.summary(),
                           "launches": dict(K.LAUNCHES), "ingest_ms": ms}, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if sys.argv[1:2] == ["--sharded-rank"]:     # one rank of phase 27 (b)
        rank, world, d, path, device_type, b, s = sys.argv[2:9]
        sharded_rank_main(int(rank), int(world), d, path, device_type,
                          int(b), int(s))
        return 0
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
            sm.phase("resume", sm.resume)
            sm.phase("compress", sm.compress)
            sm.phase("arrival", sm.arrival)
            sm.phase("timing", sm.timing_phase)
            sm.phase("attention", sm.attention)
            sm.phase("scan", sm.scan)
            sm.phase("lru", sm.lru)
            sm.phase("serve", sm.serve)
            sm.phase("serve_ssm", sm.serve_ssm)
            sm.phase("serve_hybrid", sm.serve_hybrid)
            for arch, (name, _) in FAMILIES.items():
                sm.phase(name, lambda arch=arch: sm.serve_family(arch))
            sm.phase("fileset", sm.fileset)
            sm.phase("process", sm.process)
            sm.phase("service", sm.service)
            sm.phase("numa", sm.numa)
            sm.phase("serve_vlm", sm.serve_vlm)
            sm.phase("serve_audio", sm.serve_audio)
            sm.phase("sharded", sm.sharded)
            sm.phase("examples", sm.examples)
            sm.phase("dryrun", sm.dryrun)
            sm.phase("train_ssm", sm.train_ssm)
            sm.phase("train_hybrid", sm.train_hybrid)
            sm.phase("layer_kinds", sm.layer_kinds)
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
