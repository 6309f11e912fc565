"""Architecture registry + smoke-config reducer.

``get_config(name)`` returns the exact published config; ``smoke_config``
shrinks a config to a CPU-runnable size *of the same family* (same block
pattern, same mixer kinds, few layers, tiny widths). The port carries the
dense phi4-mini-3.8b so far; the other families come with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (_phi4,)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port carries "
                       f"{sorted(ARCHS)} so far")
    return ARCHS[name]


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
    if cfg.window:
        kw["block_pattern"] = tuple(
            dataclasses.replace(s, window=min(s.window, 16) if s.window else 0)
            for s in pattern
        )
    return cfg.replace(**kw)
