"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) vocab=151936; MoE: 60 routed experts top-4
+ 4 shared experts, per-expert d_ff=1408.
"""
from repro_torch.configs.base import ATTN, MOE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    block_pattern=(LayerSpec(mixer=ATTN, ffn=MOE),),
    num_experts=60,
    expert_pad=4,                # physical 64 experts for EP-16 divisibility;
                                 # the 4 padded experts are masked from routing
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    rope_theta=1_000_000.0,
    attn_bias=True,
    tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
