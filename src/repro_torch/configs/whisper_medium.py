"""Whisper-medium [arXiv:2212.04356].

24L enc + 24L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865; learned
absolute positions, GELU MLPs, conv/mel frontend STUBBED (input_specs()
supplies precomputed frame embeddings, 1500 frames = 30 s audio).
"""
from repro_torch.configs.base import ATTN, DENSE, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,              # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    block_pattern=(LayerSpec(mixer=ATTN, ffn=DENSE),),
    use_rope=False,
    act="gelu",
    norm_eps=1e-5,
    tie_embeddings=True,
    input_mode="embeddings",
    max_position=40_960,        # learned decoder positions (covers decode_32k)
    source="arXiv:2212.04356",
)
