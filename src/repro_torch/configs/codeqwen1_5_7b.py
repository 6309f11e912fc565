"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416, qwen1.5 arch
(QKV bias, 1M rope theta for 64k context).
"""
from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    block_pattern=(LayerSpec(mixer=ATTN, ffn=DENSE),),
    rope_theta=1_000_000.0,
    attn_bias=True,
    tie_embeddings=False,
    source="hf:Qwen/CodeQwen1.5-7B",
)
