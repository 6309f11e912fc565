"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000;
pattern (RG-LRU, RG-LRU, local-attn window 2048): 8 blocks + 2 tail RG-LRU
layers; lru_width=2560, GeGLU MLPs. Decode carries O(1) recurrent state
per token and an O(window) ring cache in each local-attention layer.
"""
from repro_torch.configs.base import ATTN_LOCAL, DENSE, RGLRU, LayerSpec, ModelConfig

_REC = LayerSpec(mixer=RGLRU, ffn=DENSE)
_LOC = LayerSpec(mixer=ATTN_LOCAL, ffn=DENSE, window=2048)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=(_REC, _REC, _LOC),
    window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    act="gelu_glu",
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
