"""Qwen2-VL-2B [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936; M-RoPE with
(t, h, w) sections over the rotary dims; dynamic-resolution vision frontend
is a STUB — input_specs() supplies precomputed patch embeddings.
"""
from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=(LayerSpec(mixer=ATTN, ffn=DENSE),),
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),     # t/h/w sections, sum = head_dim//2
    attn_bias=True,
    tie_embeddings=True,
    input_mode="embeddings",
    source="arXiv:2409.12191",
)
