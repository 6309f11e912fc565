"""Falcon-Mamba-7B [arXiv:2410.05355].

64L d_model=4096, attention-free Mamba-1 blocks: d_inner=8192, ssm_state=16,
dt_rank=256, conv width 4; vocab=65024, untied head. Decode carries O(1)
state per token: the (d_inner, ssm_state) SSM state and the conv tail.
"""
from repro_torch.configs.base import MAMBA, NONE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    block_pattern=(LayerSpec(mixer=MAMBA, ffn=NONE),),
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    conv_width=4,
    ssm_chunk=256,
    use_rope=False,
    tie_embeddings=False,
    source="arXiv:2410.05355",
)
