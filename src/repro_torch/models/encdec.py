"""Encoder-decoder backbone (whisper-medium, arXiv:2212.04356).

The counterpart of the reference's ``repro/models/encdec.py``. Backbone
only, as there: the conv/mel frontend is a stub, and callers hand in
precomputed frame embeddings (B, S_enc, d). Whisper's idioms are kept:
pre-LN LayerNorm with bias, GELU MLPs with biases, learned absolute
positions (no rotary embedding), bidirectional encoder self-attention,
decoder causal self-attention and cross-attention. The reference rotates
by the identity (cos 1, sin 0), which changes no bit; the port passes
``use_rope=False``.

The reference scans over layers stacked on a leading axis; the port keeps
one param dict per layer in ``params["enc_blocks"]`` and
``params["dec_blocks"]`` and loops over them (``models/convert.py`` maps
between the two layouts).

The loss and the prefill forward (``loss_fn``, ``forward_logits``) run the
reference's plain attention, which autograd can differentiate. Decode runs
the flash-attention kernel (``ops.flash_attention``): ``init_decode_state``
runs the encoder's bidirectional self-attention through it (in bf16 at
1,500 frames, its tensor-core path), and every ``decode_step`` runs each
decoder layer's
self-attention over its KV ring (``attention_decode``) and its
cross-attention over the precomputed encoder keys and values through it.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache, attn_init, init_cache
from repro_torch.models.layers import (
    embed_init,
    embed_lookup,
    layernorm,
    layernorm_init,
    mlp_apply,
    mlp_init,
    normal_init,
    shard_act,
    softmax_xent,
    unembed_logits,
)
from repro_torch.models.transformer import _dtype, _pdtype


def init_enc_layer(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    pd = _pdtype(cfg)
    d = cfg.d_model
    return {
        "norm1": layernorm_init(d, pd, device),
        "attn": attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, pd, device, bias=True),
        "norm2": layernorm_init(d, pd, device),
        "ffn": mlp_init(gen, d, cfg.d_ff, "gelu", pd, device),
    }


def init_dec_layer(gen, cfg: ModelConfig, device) -> Dict[str, Any]:
    pd = _pdtype(cfg)
    d = cfg.d_model
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "norm1": layernorm_init(d, pd, device),
        "self_attn": attn_init(gen, d, *heads, pd, device, bias=True),
        "norm2": layernorm_init(d, pd, device),
        "cross_attn": attn_init(gen, d, *heads, pd, device, bias=True),
        "norm3": layernorm_init(d, pd, device),
        "ffn": mlp_init(gen, d, cfg.d_ff, "gelu", pd, device),
    }


def init_model(gen: torch.Generator, cfg: ModelConfig, device
               ) -> Dict[str, Any]:
    pd = _pdtype(cfg)
    d = cfg.d_model
    return {
        "embed": embed_init(gen, cfg.vocab_size, d, pd, device),
        "enc_pos": normal_init(gen, (cfg.encoder_seq, d), 0.02, pd, device),
        "dec_pos": normal_init(gen, (cfg.max_position, d), 0.02, pd, device),
        "enc_blocks": [init_enc_layer(gen, cfg, device)
                       for _ in range(cfg.encoder_layers)],
        "dec_blocks": [init_dec_layer(gen, cfg, device)
                       for _ in range(cfg.num_layers)],
        "enc_final": layernorm_init(d, pd, device),
        "dec_final": layernorm_init(d, pd, device),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           kernel: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, d) precomputed frontend embeddings -> the
    encoder output (B, S_enc, d). ``kernel`` runs the self-attention
    through ``ops.flash_attention(causal=False)``; otherwise it is the
    reference's plain attention."""
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    S = frames.shape[1]
    x = frames.to(dt) + params["enc_pos"][:S].to(dt)
    x = shard_act(x, "batch", None, None)
    for lp in params["enc_blocks"]:
        x = x + attn_mod.bidirectional_attention(
            lp["attn"], layernorm(lp["norm1"], x, eps), dtype=dt, eps=eps,
            kernel=kernel)
        x = x + mlp_apply(lp["ffn"], layernorm(lp["norm2"], x, eps), "gelu",
                          dt)
    return layernorm(params["enc_final"], x, eps)


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor, last_only: bool = False
                 ) -> torch.Tensor:
    """Teacher-forced decoder forward -> logits (B, S_dec, V), in the
    reference's plain attention."""
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens, dt)
    x = x + params["dec_pos"][:S].to(dt)
    for lp in params["dec_blocks"]:
        x = x + attn_mod.attention_train(
            lp["self_attn"], layernorm(lp["norm1"], x, eps), None, None,
            dtype=dt, eps=eps, causal=True, use_rope=False,
            q_chunk=cfg.attn_q_chunk)
        kv = attn_mod.cross_kv(lp["cross_attn"], enc_out, dt)
        x = x + attn_mod.cross_attention(
            lp["cross_attn"], layernorm(lp["norm2"], x, eps), kv, dtype=dt,
            kernel=False)
        x = x + mlp_apply(lp["ffn"], layernorm(lp["norm3"], x, eps), "gelu",
                          dt)
    x = layernorm(params["dec_final"], x, eps)
    if last_only:
        x = x[:, -1:]     # slice before unembedding, as the reference
    return unembed_logits(params["embed"], x, dt)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: ``{"embeds": (B, S_enc, d), "tokens", "labels": (B, S)}``."""
    enc = encode(params, cfg, batch["embeds"])
    logits = decode_train(params, cfg, batch["tokens"], enc)
    xent = softmax_xent(logits, batch["labels"], mode=cfg.xent_mode)
    return xent, {"xent": xent,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=xent.device)}


def forward_logits(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   last_only: bool = True) -> torch.Tensor:
    enc = encode(params, cfg, batch["embeds"])
    return decode_train(params, cfg, batch["tokens"], enc,
                        last_only=last_only)


# -- incremental decode ---------------------------------------------------------
class EncDecState(NamedTuple):
    """One self-attention ring a decoder layer, one cross-attention (k, v)
    pair a decoder layer (each (B, S_enc, K, hd)), and the next position
    (a host int)."""
    self_caches: List[KVCache]
    cross_kv: List[Tuple[torch.Tensor, torch.Tensor]]
    pos: int


def init_decode_state(params, cfg: ModelConfig, frames: torch.Tensor,
                      seq_budget: int) -> EncDecState:
    """Run the encoder once through the flash-attention kernel,
    precompute every decoder layer's cross-attention keys and values, and
    allocate one empty self-attention ring of ``seq_budget`` slots a
    decoder layer, on the device of ``frames``. The kernel is
    forward-only: callers run this under ``torch.no_grad()`` where the
    params require a gradient, as the serving paths do."""
    dt = _dtype(cfg)
    enc = encode(params, cfg, frames, kernel=True)
    B = frames.shape[0]
    cross = [attn_mod.cross_kv(lp["cross_attn"], enc, dt)
             for lp in params["dec_blocks"]]
    caches = [init_cache(B, seq_budget, cfg.num_kv_heads,
                         cfg.resolved_head_dim, dt, frames.device)
              for _ in range(cfg.num_layers)]
    return EncDecState(self_caches=caches, cross_kv=cross, pos=0)


def decode_step(params, cfg: ModelConfig, state: EncDecState,
                batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, EncDecState]:
    """One token for every sequence: batch ``{"tokens": (B, 1)}`` ->
    (logits (B, 1, V), the state with the rings updated in place and
    ``pos + 1``). Each layer's self-attention and cross-attention go
    through the flash-attention kernel on CUDA tensors."""
    dt = _dtype(cfg)
    eps = cfg.norm_eps
    pos = state.pos
    x = embed_lookup(params["embed"], batch["tokens"], dt)
    x = x + params["dec_pos"][pos:pos + 1].to(dt)
    caches = []
    for lp, cache, ckv in zip(params["dec_blocks"], state.self_caches,
                              state.cross_kv):
        a, cache = attn_mod.attention_decode(
            lp["self_attn"], layernorm(lp["norm1"], x, eps), cache, pos,
            None, None, dtype=dt, eps=eps, use_rope=False)
        x = x + a
        x = x + attn_mod.cross_attention(
            lp["cross_attn"], layernorm(lp["norm2"], x, eps), ckv, dtype=dt,
            kernel=True)
        x = x + mlp_apply(lp["ffn"], layernorm(lp["norm3"], x, eps), "gelu",
                          dt)
        caches.append(cache)
    x = layernorm(params["dec_final"], x, eps)
    return (unembed_logits(params["embed"], x, dt),
            EncDecState(self_caches=caches, cross_kv=state.cross_kv,
                        pos=pos + 1))
