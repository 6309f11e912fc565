"""OLMoE-1B-7B [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) vocab=50304; MoE: 64 experts top-8,
per-expert d_ff=1024, QK-norm.
"""
from repro_torch.configs.base import ATTN, MOE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    block_pattern=(LayerSpec(mixer=ATTN, ffn=MOE),),
    num_experts=64,
    num_shared_experts=0,
    top_k=8,
    moe_d_ff=1024,
    rope_theta=10_000.0,
    qk_norm=True,
    tie_embeddings=False,
    source="arXiv:2409.02060",
)
