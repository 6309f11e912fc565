"""Phi-3-medium-14B [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352, RoPE + SwiGLU.
The reference's 16-way model mesh axis divides neither head count; the
port runs on one device, so nothing is padded.
"""
from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    block_pattern=(LayerSpec(mixer=ATTN, ffn=DENSE),),
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2404.14219",
)
