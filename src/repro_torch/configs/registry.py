"""Architecture registry + smoke-config reducer.

``get_config(name)`` returns the exact published config; ``smoke_config``
shrinks a config to a CPU-runnable size *of the same family* (same block
pattern, same mixer kinds, few layers, tiny widths). The port carries every
family of the reference: the dense phi4-mini-3.8b, codeqwen1.5-7b,
phi3-medium-14b and gemma3-27b (5 local : 1 global attention), the MoE
qwen2-moe-a2.7b (padded and shared experts) and olmoe-1b-7b, the SSM
falcon-mamba-7b, the hybrid recurrentgemma-2b, the VLM qwen2-vl-2b (M-RoPE,
patch-embedding input) and the encoder-decoder whisper-medium.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.codeqwen1_5_7b import CONFIG as _codeqwen
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl
from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma
from repro_torch.configs.whisper_medium import CONFIG as _whisper

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_qwen2_moe, _olmoe, _qwen2_vl, _codeqwen, _phi4, _phi3,
                        _gemma3, _whisper, _falcon_mamba, _recurrentgemma)}

# long_500k applicability: only sub-quadratic decode families run it
LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    return sorted(ARCHS)


def cells(include_long_for_all: bool = False):
    """Yield every assigned (arch, shape) cell, honouring the long_500k rule."""
    for name in list_archs():
        for shape in SHAPES:
            if (
                shape.name == "long_500k"
                and not include_long_for_all
                and name not in LONG_CONTEXT_ARCHS
            ):
                continue
            yield name, shape


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: 2 scan blocks + original tail remainder."""
    pattern = cfg.block_pattern
    tail_len = cfg.num_layers % len(pattern)
    num_layers = 2 * len(pattern) + tail_len
    hd = 16
    heads = max(2, min(4, cfg.num_heads or 2))
    kv = 1 if cfg.num_kv_heads <= 1 else 2
    # keep M-RoPE sections proportional: sum must equal hd//2
    mrope = (2, 3, 3) if cfg.mrope_sections else ()
    kw = dict(
        num_layers=num_layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv if cfg.num_kv_heads else 0,
        head_dim=hd,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        mrope_sections=mrope,
        window=min(cfg.window, 16) if cfg.window else 0,
        max_position=4096,
    )
    if cfg.num_experts:
        kw.update(num_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32,
                  num_shared_experts=min(cfg.num_shared_experts, 2))
    if cfg.ssm_state:
        kw.update(d_inner=128, ssm_state=4, dt_rank=8, ssm_chunk=16)
    if cfg.lru_width:
        kw.update(lru_width=64)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=32)
    # rebuild block pattern with the reduced window
    if cfg.window:
        kw["block_pattern"] = tuple(
            dataclasses.replace(s, window=min(s.window, 16) if s.window else 0)
            for s in pattern
        )
    return cfg.replace(**kw)


def smoke_shape(shape: ShapeConfig) -> ShapeConfig:
    """Tiny shape of the same kind for CPU smoke runs."""
    return ShapeConfig(
        name=f"smoke_{shape.name}",
        seq_len=32,
        global_batch=2,
        kind=shape.kind,
    )
