"""Decoder-only transformer stack: train/prefill forward and decode.

The reference scans over whole blocks of stacked params; the port keeps one
param dict per layer in ``params["layers"]`` (schedule order) and loops
over them. With ``remat_policy != "none"`` each block of
``len(cfg.block_pattern)`` layers runs under activation checkpointing, the
port's counterpart of the reference's per-block ``jax.checkpoint``.
``models/convert.py`` maps between the two layouts.

Decode keeps one KV cache per layer in ``DecodeState.layers`` (schedule
order, like the params) and the next position as a host int, so that
slicing the valid cache prefix needs no device sync; the caches are updated
in place (``attention_decode``).

The port carries dense attention blocks (phi4-mini) so far; the other mixer
and FFN kinds raise ``NotImplementedError`` and come with their families.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ATTN_LOCAL, DENSE, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache, attn_init, init_cache
from repro_torch.models.layers import (
    embed_init,
    embed_lookup,
    fan_in_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    rope_angles,
    softmax_xent,
    unembed_logits,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _check_spec(spec) -> None:
    if spec.mixer not in (ATTN, ATTN_LOCAL) or spec.ffn != DENSE:
        raise NotImplementedError(
            f"layer kind ({spec.mixer}, {spec.ffn}) is not carried by the "
            f"port yet: it comes with its model family (ROADMAP.md, Queue A)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec, device
               ) -> Dict[str, Any]:
    _check_spec(spec)
    pd = _pdtype(cfg)
    d = cfg.d_model
    return {
        "norm1": rmsnorm_init(d, pd, device),
        "mixer": attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, pd, device,
                           bias=cfg.attn_bias, qk_norm=cfg.qk_norm),
        "norm2": rmsnorm_init(d, pd, device),
        "ffn": mlp_init(gen, d, cfg.d_ff, cfg.act, pd, device),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig, device
               ) -> Dict[str, Any]:
    if cfg.num_heads_phys or cfg.num_kv_heads_phys:
        raise NotImplementedError("physical head padding comes with the "
                                  "sharding slice (ROADMAP.md, Queue A)")
    pd = _pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd, device),
        "final_norm": rmsnorm_init(cfg.d_model, pd, device),
        "layers": [init_layer(gen, cfg, spec, device)
                   for spec in cfg.layer_schedule()],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": fan_in_init(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model, pd, device)}
    return params


# ---------------------------------------------------------------------------
# train / prefill forward
# ---------------------------------------------------------------------------
def apply_layer_train(params, spec, cfg: ModelConfig, x, cos, sin
                      ) -> torch.Tensor:
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    h = rmsnorm(params["norm1"], x, eps)
    x = x + attn_mod.attention_train(
        params["mixer"], h, cos, sin, dtype=dt, eps=eps, causal=True,
        window=spec.window, softcap=cfg.attn_logit_softcap,
        use_rope=cfg.use_rope, q_chunk=cfg.attn_q_chunk,
    )
    h = rmsnorm(params["norm2"], x, eps)
    return x + mlp_apply(params["ffn"], h, cfg.act, dt)


def forward_backbone(params, cfg: ModelConfig, x, cos, sin) -> torch.Tensor:
    if cfg.remat_policy not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")
    schedule = cfg.layer_schedule()
    per_block = len(cfg.block_pattern)
    nb = cfg.num_layers // per_block
    layers = params["layers"]

    def run(x, lo: int, hi: int):
        for i in range(lo, hi):
            x = apply_layer_train(layers[i], schedule[i], cfg, x, cos, sin)
        return x

    for b in range(nb):
        lo, hi = b * per_block, (b + 1) * per_block
        if cfg.remat_policy == "none" or not torch.is_grad_enabled():
            x = run(x, lo, hi)
        else:
            # "dots" and "full" both recompute the block in the backward
            # pass (the reference's "dots" also keeps matmul outputs).
            x = checkpoint(run, x, lo, hi, use_reentrant=False)
    x = run(x, nb * per_block, cfg.num_layers)        # tail layers
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _positions(batch: Dict[str, torch.Tensor], S: int, B: int, device):
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _input_x(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode={cfg.input_mode!r} comes with the vlm/audio slices")
    tokens = batch["tokens"]
    B, S = tokens.shape
    return embed_lookup(params["embed"], tokens, _dtype(cfg)), B, S


def _logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed_logits(params["embed"], x, _dtype(cfg))
    return x @ params["lm_head"]["w"].to(_dtype(cfg))


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full train forward -> (scalar loss fp32, metrics)."""
    x, B, S = _input_x(params, cfg, batch)
    pos = _positions(batch, S, B, x.device)
    cos, sin = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    x = forward_backbone(params, cfg, x, cos, sin)
    xent = softmax_xent(_logits(params, cfg, x), batch["labels"],
                        mode=cfg.xent_mode)
    # Dense blocks carry no router loss: aux is 0, as in the reference.
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return xent + cfg.router_aux_coef * aux, {"xent": xent, "aux": aux}


def forward_logits(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   last_only: bool = True) -> torch.Tensor:
    """Prefill forward (no labels). Returns last-position logits by default."""
    x, B, S = _input_x(params, cfg, batch)
    pos = _positions(batch, S, B, x.device)
    cos, sin = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    x = forward_backbone(params, cfg, x, cos, sin)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    layers: List[KVCache]  # one cache per layer, schedule order
    pos: int               # next absolute position (host int)


def _layer_capacity(cfg: ModelConfig, spec, seq_budget: int) -> int:
    if spec.mixer == ATTN_LOCAL and spec.window > 0:
        return min(spec.window, seq_budget)
    return seq_budget


def init_layer_state(cfg: ModelConfig, spec, batch: int, seq_budget: int,
                     device) -> KVCache:
    _check_spec(spec)
    return init_cache(batch, _layer_capacity(cfg, spec, seq_budget),
                      cfg.num_kv_heads, cfg.resolved_head_dim, _dtype(cfg),
                      device)


def init_decode_state(cfg: ModelConfig, batch: int, seq_budget: int, device,
                      pos: int = 0) -> DecodeState:
    return DecodeState(
        layers=[init_layer_state(cfg, spec, batch, seq_budget, device)
                for spec in cfg.layer_schedule()],
        pos=pos)


def apply_layer_decode(params, state: KVCache, spec, cfg: ModelConfig, x,
                       pos: int, cos, sin) -> Tuple[torch.Tensor, KVCache]:
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    h = rmsnorm(params["norm1"], x, eps)
    m, new_state = attn_mod.attention_decode(
        params["mixer"], h, state, pos, cos, sin, dtype=dt, eps=eps,
        window=spec.window, softcap=cfg.attn_logit_softcap,
        use_rope=cfg.use_rope,
    )
    x = x + m
    h = rmsnorm(params["norm2"], x, eps)
    return x + mlp_apply(params["ffn"], h, cfg.act, dt), new_state


def decode_step(params, cfg: ModelConfig, state: DecodeState,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every sequence in the batch.

    batch: ``{"tokens": (B, 1)}``. Returns (logits (B, 1, V), new state);
    the new state holds the same (updated) caches and ``pos + 1``."""
    x, B, _ = _input_x(params, cfg, batch)
    pos = state.pos
    pos_ids = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = rope_angles(pos_ids, cfg.resolved_head_dim, cfg.rope_theta,
                           cfg.mrope_sections)
    layers = []
    for lp, ls, spec in zip(params["layers"], state.layers,
                            cfg.layer_schedule()):
        x, ns = apply_layer_decode(lp, ls, spec, cfg, x, pos, cos, sin)
        layers.append(ns)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), DecodeState(layers=layers, pos=pos + 1)
