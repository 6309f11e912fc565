"""Decoder-only transformer stack: train/prefill forward and decode.

The reference scans over whole blocks of stacked params; the port keeps one
param dict per layer in ``params["layers"]`` (schedule order) and loops
over them. With ``remat_policy != "none"`` each block of
``len(cfg.block_pattern)`` layers runs under activation checkpointing, the
port's counterpart of the reference's per-block ``jax.checkpoint``.
``models/convert.py`` maps between the two layouts.

Decode keeps one state per layer in ``DecodeState.layers`` (schedule
order, like the params): a KV cache for an attention layer, a ring for a
local-window layer, updated in place (``attention_decode``), a
``MambaState`` for a Mamba layer, or an ``RGLRUState`` for an RG-LRU
layer. The next position is a host int, so that picking the cache slots to
attend over needs no device sync.

A layer is any mixer of the reference's (global attention, local-window
attention, a Mamba-1 block of ``models/ssm.py``, Griffin's RG-LRU block of
``models/rglru.py``) followed by any of its FFNs (a dense SwiGLU or GeGLU
MLP, a Mixture-of-Experts FFN of ``models/moe.py``, or none): all twelve
kinds compose as in the reference. The families use five of them (dense
attention in phi4-mini, codeqwen, phi3-medium, gemma3 and qwen2-vl, whose
input may be patch embeddings ``{"embeds", "positions"}`` with 3-D M-RoPE
positions; MoE attention in qwen2-moe and olmoe; FFN-free Mamba in
falcon-mamba; dense RG-LRU and local attention in recurrentgemma). An MoE
layer's router loss is summed over the stack (through the checkpointed
blocks too) and added to the loss with weight ``router_aux_coef``, as in
the reference. An unknown mixer raises ``ValueError``, as there.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    DENSE,
    MAMBA,
    MOE,
    NONE,
    RGLRU,
    ModelConfig,
)
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
    shard_act,
    softmax_xent,
    unembed_logits,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import (
    MambaState,
    mamba_apply,
    mamba_decode,
    mamba_init,
    mamba_init_state,
)
from repro_torch.models.rglru import (
    RGLRUState,
    rglru_apply,
    rglru_decode,
    rglru_init,
    rglru_init_state,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, spec, device
               ) -> Dict[str, Any]:
    pd = _pdtype(cfg)
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": rmsnorm_init(d, pd, device)}
    if spec.mixer in (ATTN, ATTN_LOCAL):
        p["mixer"] = attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim, pd, device,
                               bias=cfg.attn_bias, qk_norm=cfg.qk_norm,
                               phys_heads=cfg.num_heads_phys,
                               phys_kv=cfg.num_kv_heads_phys)
    elif spec.mixer == MAMBA:
        p["mixer"] = mamba_init(gen, d, cfg.d_inner, cfg.ssm_state,
                                cfg.dt_rank, cfg.conv_width, pd, device)
    elif spec.mixer == RGLRU:
        p["mixer"] = rglru_init(gen, d, cfg.lru_width, cfg.conv_width, pd,
                                device)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn != NONE:
        p["norm2"] = rmsnorm_init(d, pd, device)
        if spec.ffn == DENSE:
            p["ffn"] = mlp_init(gen, d, cfg.d_ff, cfg.act, pd, device)
        else:
            p["ffn"] = moe_init(gen, d, cfg.num_experts, cfg.moe_d_ff,
                                cfg.num_shared_experts, pd, device,
                                expert_pad=cfg.expert_pad)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig, device
               ) -> Dict[str, Any]:
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
def _ffn(params, spec, cfg: ModelConfig, h, dt):
    """(the FFN's output, its router loss or None for a dense MLP)."""
    if spec.ffn == DENSE:
        return mlp_apply(params["ffn"], h, cfg.act, dt), None
    return moe_apply(params["ffn"], h, top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor, dtype=dt,
                     num_real_experts=cfg.num_experts)


def apply_layer_train(params, spec, cfg: ModelConfig, x, cos, sin
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the layer's output, its router loss: 0 but for an MoE layer)."""
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    h = rmsnorm(params["norm1"], x, eps)
    if spec.mixer in (ATTN, ATTN_LOCAL):
        x = x + attn_mod.attention_train(
            params["mixer"], h, cos, sin, dtype=dt, eps=eps, causal=True,
            window=spec.window, softcap=cfg.attn_logit_softcap,
            use_rope=cfg.use_rope, q_chunk=cfg.attn_q_chunk,
        )
    elif spec.mixer == MAMBA:
        x = x + mamba_apply(params["mixer"], h, dtype=dt, impl=cfg.ssm_impl)
    elif spec.mixer == RGLRU:
        x = x + rglru_apply(params["mixer"], h, dtype=dt)
    else:
        raise ValueError(spec.mixer)
    aux = None
    if spec.ffn != NONE:
        f, aux = _ffn(params, spec, cfg, rmsnorm(params["norm2"], x, eps), dt)
        x = x + f
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard_act(x, "batch", None, None), aux


def forward_backbone(params, cfg: ModelConfig, x, cos, sin
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-normed hidden states, the router loss summed over the
    layers in schedule order, the reference's scan carry)."""
    if cfg.remat_policy not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")
    schedule = cfg.layer_schedule()
    per_block = len(cfg.block_pattern)
    nb = cfg.num_layers // per_block
    layers = params["layers"]

    def run(x, aux, lo: int, hi: int):
        for i in range(lo, hi):
            x, a = apply_layer_train(layers[i], schedule[i], cfg, x, cos, sin)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(nb):
        lo, hi = b * per_block, (b + 1) * per_block
        if cfg.remat_policy == "none" or not torch.is_grad_enabled():
            x, aux = run(x, aux, lo, hi)
        else:
            # "dots" and "full" both recompute the block in the backward
            # pass (the reference's "dots" also keeps matmul outputs).
            x, aux = checkpoint(run, x, aux, lo, hi, use_reentrant=False)
    x, aux = run(x, aux, nb * per_block, cfg.num_layers)     # tail layers
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _positions(batch: Dict[str, torch.Tensor], S: int, B: int, device):
    """The batch's ``positions`` ((B, S), or (B, S, 3) under M-RoPE), else
    ``0..S-1``. (B, S) positions under M-RoPE take ``rope_angles``' 1-D
    rotation, which is every section sharing one coordinate."""
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _rope(cfg: ModelConfig, pos: torch.Tensor):
    """(cos, sin) of the positions; None for an attention-free stack,
    which has no rotary embedding to apply."""
    if cfg.attention_free:
        return None, None
    return rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta,
                       cfg.mrope_sections)


def _input_x(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(x, B, S): the batch's ``embeds`` (B, S, d) cast to the compute
    dtype when the config takes embeddings (qwen2-vl's patch embeddings;
    the vision frontend is a stub, as in the reference), else its
    ``tokens`` (B, S) looked up in the table."""
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = shard_act(batch["embeds"].to(_dtype(cfg)), "batch", None, None)
        return x, x.shape[0], x.shape[1]
    tokens = batch["tokens"]
    B, S = tokens.shape
    return embed_lookup(params["embed"], tokens, _dtype(cfg)), B, S


def _logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed_logits(params["embed"], x, _dtype(cfg))
    return shard_act(x @ params["lm_head"]["w"].to(_dtype(cfg)),
                     "batch", None, "model")


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full train forward -> (scalar loss fp32, metrics)."""
    x, B, S = _input_x(params, cfg, batch)
    cos, sin = _rope(cfg, _positions(batch, S, B, x.device))
    x, aux = forward_backbone(params, cfg, x, cos, sin)
    xent = softmax_xent(_logits(params, cfg, x), batch["labels"],
                        mode=cfg.xent_mode)
    return xent + cfg.router_aux_coef * aux, {"xent": xent, "aux": aux}


def forward_logits(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   last_only: bool = True) -> torch.Tensor:
    """Prefill forward (no labels). Returns last-position logits by default."""
    x, B, S = _input_x(params, cfg, batch)
    cos, sin = _rope(cfg, _positions(batch, S, B, x.device))
    x, _ = forward_backbone(params, cfg, x, cos, sin)
    if last_only:
        x = x[:, -1:]
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
LayerState = Union[KVCache, MambaState, RGLRUState]


class DecodeState(NamedTuple):
    layers: List[LayerState]  # one state per layer, schedule order
    pos: int                  # next absolute position (host int)


def _layer_capacity(cfg: ModelConfig, spec, seq_budget: int) -> int:
    if spec.mixer == ATTN_LOCAL and spec.window > 0:
        return min(spec.window, seq_budget)
    return seq_budget


def init_layer_state(cfg: ModelConfig, spec, batch: int, seq_budget: int,
                     device) -> LayerState:
    if spec.mixer in (ATTN, ATTN_LOCAL):
        return init_cache(batch, _layer_capacity(cfg, spec, seq_budget),
                          cfg.num_kv_heads_phys or cfg.num_kv_heads,
                          cfg.resolved_head_dim, _dtype(cfg), device)
    if spec.mixer == MAMBA:
        return mamba_init_state(batch, cfg.d_inner, cfg.ssm_state,
                                cfg.conv_width, _dtype(cfg), device)
    if spec.mixer == RGLRU:
        return rglru_init_state(batch, cfg.lru_width, cfg.conv_width,
                                _dtype(cfg), device)
    raise ValueError(spec.mixer)


def init_decode_state(cfg: ModelConfig, batch: int, seq_budget: int, device,
                      pos: int = 0) -> DecodeState:
    return DecodeState(
        layers=[init_layer_state(cfg, spec, batch, seq_budget, device)
                for spec in cfg.layer_schedule()],
        pos=pos)


def apply_layer_decode(params, state: LayerState, spec, cfg: ModelConfig, x,
                       pos: int, cos, sin) -> Tuple[torch.Tensor, LayerState]:
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    h = rmsnorm(params["norm1"], x, eps)
    if spec.mixer in (ATTN, ATTN_LOCAL):
        m, new_state = attn_mod.attention_decode(
            params["mixer"], h, state, pos, cos, sin, dtype=dt, eps=eps,
            window=spec.window, softcap=cfg.attn_logit_softcap,
            use_rope=cfg.use_rope,
        )
    elif spec.mixer == MAMBA:
        m, new_state = mamba_decode(params["mixer"], h, state, dtype=dt)
    elif spec.mixer == RGLRU:
        m, new_state = rglru_decode(params["mixer"], h, state, dtype=dt)
    else:
        raise ValueError(spec.mixer)
    x = x + m
    if spec.ffn == NONE:
        return x, new_state
    # An MoE layer routes the one token (S = 1), as the reference does.
    f, _ = _ffn(params, spec, cfg, rmsnorm(params["norm2"], x, eps), dt)
    return x + f, new_state


def decode_step(params, cfg: ModelConfig, state: DecodeState,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every sequence in the batch.

    batch: ``{"tokens": (B, 1)}``, or ``{"embeds": (B, 1, d)}`` for a
    config that takes embeddings. Returns (logits (B, 1, V), new state);
    the new state holds the same (updated) caches, the new recurrent states
    and ``pos + 1``. Under M-RoPE every section rotates by the one
    position, as the reference's broadcast (B, 1, 3) position does."""
    x, B, _ = _input_x(params, cfg, batch)
    pos = state.pos
    cos, sin = _rope(cfg, torch.full((B, 1), pos, dtype=torch.int32,
                                     device=x.device))
    layers = []
    for lp, ls, spec in zip(params["layers"], state.layers,
                            cfg.layer_schedule()):
        x, ns = apply_layer_decode(lp, ls, spec, cfg, x, pos, cos, sin)
        layers.append(ns)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), DecodeState(layers=layers, pos=pos + 1)
