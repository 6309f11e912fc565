"""Model / run configuration system.

``ModelConfig`` is the single source of truth for an architecture. Each
assigned arch gets one file in this package instantiating it with the exact
published dimensions. Layer heterogeneity (gemma3's 5:1 local:global,
recurrentgemma's 1:2 attn:recurrent) is expressed as a repeating
``block_pattern`` of ``LayerSpec`` entries; the model stack scans over whole
blocks and unrolls the remainder (`tail`), keeping compile time and HLO size
bounded for 62-layer models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# Mixer kinds
ATTN = "attn"            # global causal (or bidirectional in encoders)
ATTN_LOCAL = "attn_local"  # sliding-window causal
RGLRU = "rglru"          # Griffin recurrent block
MAMBA = "mamba"          # Mamba-1 selective SSM block (no separate FFN)

# FFN kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = ATTN
    ffn: str = DENSE
    window: int = 0          # >0 for attn_local

    def __post_init__(self):
        assert self.mixer in (ATTN, ATTN_LOCAL, RGLRU, MAMBA), self.mixer
        assert self.ffn in (DENSE, MOE, NONE), self.ffn


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str                  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|vlm|audio|ssm|hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # layer schedule: pattern repeated, remainder unrolled
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    expert_pad: int = 0          # physical padding to a multiple of the EP axis
                                 # (padded experts are masked out of routing)

    # positional
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) in rope pairs
    use_rope: bool = True                  # whisper uses learned abs positions

    # local attention
    window: int = 0

    # q-chunked attention (XLA-native flash equivalent): sequences longer
    # than this are processed in q-chunks with per-chunk remat, bounding the
    # score tensor to (B, K, G, chunk, S) — required for 32k+ prefill to fit
    attn_q_chunk: int = 2048

    # SSM (mamba1)
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    ssm_chunk: int = 256

    # RG-LRU
    lru_width: int = 0

    # encoder-decoder (whisper): encoder layers use bidirectional attention
    encoder_layers: int = 0
    encoder_seq: int = 0                 # fixed encoder length (1500 frames)

    # misc arch
    norm_eps: float = 1e-6
    act: str = "silu"                    # silu/gelu_glu (GLU) | gelu (plain MLP)
    attn_bias: bool = False              # qwen-family QKV bias
    qk_norm: bool = False                # gemma3/olmoe query-key RMSNorm
    attn_logit_softcap: float = 0.0
    tie_embeddings: bool = True

    # input stub mode: "tokens" | "embeddings" (vlm/audio frontends)
    input_mode: str = "tokens"

    # runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "dots"           # none|dots|full
    scan_layers: bool = True             # False -> unroll (exact HLO cost analysis)
    max_position: int = 1_048_576
    # §Perf levers (baseline defaults; see EXPERIMENTS.md for the iterations)
    xent_mode: str = "gather"            # gather | onehot (sharded-vocab friendly)
    ssm_impl: str = "materialized"       # materialized | fused (per-chunk discretize)
    # physical head padding (0 = none): pad (H, K) to TP-divisible counts
    # with the SAME group ratio G=H/K; padded slices are zero-initialized and
    # stay zero under gradient flow — exact math, eliminates the head_dim-
    # sharding fallback's score-psum collectives (§Perf B)
    num_heads_phys: int = 0
    num_kv_heads_phys: int = 0

    # citation (source of the numbers)
    source: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(s.mixer in (MAMBA, RGLRU) for s in self.block_pattern)

    def layer_schedule(self) -> List[LayerSpec]:
        """Full per-layer schedule (pattern cycled to num_layers)."""
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.num_layers)]

    def scan_split(self) -> Tuple[Tuple[LayerSpec, ...], int, Tuple[LayerSpec, ...]]:
        """(block_pattern, num_full_blocks, tail_layers)."""
        p = self.block_pattern
        nb = self.num_layers // len(p)
        tail = tuple(self.layer_schedule()[nb * len(p):])
        return p, nb, tail

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6·N·D) --------------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.resolved_head_dim
        H, K = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            return d * H * hd + 2 * d * K * hd + H * hd * d

        def dense_ffn(ff: int) -> int:
            if self.act in ("silu", "gelu_glu"):
                return 3 * d * ff        # GLU: gate, up, down
            return 2 * d * ff            # plain MLP

        def mamba_params() -> int:
            di, n, r = self.d_inner, self.ssm_state, self.dt_rank
            return (
                d * 2 * di               # in_proj
                + di * self.conv_width   # depthwise conv
                + di * (r + 2 * n)       # x_proj
                + r * di + di            # dt_proj
                + di * n + di            # A_log, D
                + di * d                 # out_proj
            )

        def rglru_block() -> int:
            w = self.lru_width
            return (
                2 * d * w                # gate & recurrent input projections
                + w * self.conv_width    # temporal conv
                + 2 * w                  # a-gate params (Lambda, input gate)
                + 2 * w * w // 1         # rg-lru input/recurrence gates (per-head dense approx)
                + w * d                  # out proj
            )

        total = embed + head
        active = embed + head
        for spec in self.layer_schedule():
            if spec.mixer in (ATTN, ATTN_LOCAL):
                total += attn_params(); active += attn_params()
            elif spec.mixer == MAMBA:
                total += mamba_params(); active += mamba_params()
            elif spec.mixer == RGLRU:
                total += rglru_block(); active += rglru_block()
            if spec.ffn == DENSE:
                total += dense_ffn(self.d_ff); active += dense_ffn(self.d_ff)
            elif spec.ffn == MOE:
                per_expert = dense_ffn(self.moe_d_ff)
                total += self.num_experts * per_expert
                total += self.num_shared_experts * per_expert
                total += d * self.num_experts            # router
                active += self.top_k * per_expert
                active += self.num_shared_experts * per_expert
                active += d * self.num_experts
            total += 2 * d               # norms
            active += 2 * d
        if self.is_encdec:
            # encoder stack: bidirectional attn + dense ffn (+ cross-attn in decoder
            # counted as one extra attn per decoder layer)
            enc = self.encoder_layers * (attn_params() + dense_ffn(self.d_ff) + 2 * d)
            cross = self.num_layers * attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": total, "active": active}
