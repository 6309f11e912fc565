"""Gemma-3-27B [hf:google/gemma-3-1b-pt family].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; 5:1 local:global
attention pattern (local window 1024), QK-norm, GeGLU. 62 = 10 scanned
blocks of (5 local + 1 global) + 2 unrolled local tail layers.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, DENSE, LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer=ATTN_LOCAL, ffn=DENSE, window=1024)
_GLOBAL = LayerSpec(mixer=ATTN, ffn=DENSE)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    window=1024,
    rope_theta=1_000_000.0,
    qk_norm=True,
    act="gelu_glu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (27B dims)",
)
