"""Attention, train half: GQA/MQA/MHA with causal and sliding-window masks.

The math is the reference's XLA path (``repro/models/attention.py``): scores
in fp32, probabilities cast back to the compute dtype before the PV product.
Like the reference model, it does not call the flash-attention kernel.
Decode (the ring-buffer KV cache) comes with the serving slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import apply_rope, fan_in_init, rmsnorm, rmsnorm_init, shard_act

NEG_INF = -2.0e38


def attn_init(gen, d: int, heads: int, kv_heads: int, head_dim: int, dtype,
              device, bias: bool = False, qk_norm: bool = False) -> dict:
    p = {
        "wq": fan_in_init(gen, (d, heads, head_dim), d, dtype, device),
        "wk": fan_in_init(gen, (d, kv_heads, head_dim), d, dtype, device),
        "wv": fan_in_init(gen, (d, kv_heads, head_dim), d, dtype, device),
        "wo": fan_in_init(gen, (heads, head_dim, d), heads * head_dim, dtype,
                          device),
    }
    if bias:
        p["bq"] = torch.zeros((heads, head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv_heads, head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv_heads, head_dim), dtype=dtype, device=device)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, dtype, device)
        p["k_norm"] = rmsnorm_init(head_dim, dtype, device)
    return p


def _project_qkv(params: dict, x: torch.Tensor, dtype, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if "bq" in params:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q, eps)
        k = rmsnorm(params["k_norm"], k, eps)
    return q, k, v


def _sdpa(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, K, hd)
    v: torch.Tensor,            # (B, Sk, K, hd)
    *,
    mask: Optional[torch.Tensor],   # broadcastable to (B, K, G, Sq, Sk)
    softcap: float = 0.0,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    scores = scores.float()
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def causal_window_mask(sq: int, sk: int, window: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """(1,1,1,Sq,Sk) bool: j <= i+offset and (window==0 or i+offset-j < window)."""
    i = torch.arange(sq, device=device)[:, None] + offset
    j = torch.arange(sk, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= (i - j) < window
    return m[None, None, None]


def _chunked_sdpa(q, k, v, *, causal: bool, window: int, softcap: float,
                  q_chunk: int) -> torch.Tensor:
    """q-chunked attention: the live score tensor is (B, K, G, q_chunk, S),
    and each chunk is recomputed in the backward pass (activation
    checkpointing), so activation memory is one chunk."""
    B, S, H, hd = q.shape
    nc = S // q_chunk

    def one_chunk(qs, k, v, i: int):
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        m = torch.ones((q_chunk, S), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window > 0:
            m &= (qpos - kpos) < window
        return _sdpa(qs, k, v, mask=m[None, None, None], softcap=softcap)

    outs = [
        checkpoint(one_chunk, q[:, i * q_chunk:(i + 1) * q_chunk], k, v, i,
                   use_reentrant=False)
        for i in range(nc)
    ]
    return torch.cat(outs, dim=1)


def attention_train(
    params: dict,
    x: torch.Tensor,               # (B, S, d)
    cos: torch.Tensor, sin: torch.Tensor,
    *,
    dtype,
    eps: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    use_rope: bool = True,
    q_chunk: int = 0,
) -> torch.Tensor:
    q, k, v = _project_qkv(params, x, dtype, eps)
    if use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    S = x.shape[1]
    if q_chunk and S > q_chunk and S % q_chunk == 0 and causal:
        out = _chunked_sdpa(q, k, v, causal=causal, window=window,
                            softcap=softcap, q_chunk=q_chunk)
    else:
        mask = (causal_window_mask(S, S, window, device=x.device)
                if causal else None)
        out = _sdpa(q, k, v, mask=mask, softcap=softcap)
    out = shard_act(out, "batch", None, "model", None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
