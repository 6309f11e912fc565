"""Shared neural building blocks (plain functions on tensors, dict params).

Conventions follow the reference package:
  * params live in ``param_dtype`` (fp32), compute casts to ``dtype``
    (bf16); norms and the softmax accumulate in fp32;
  * ``shard_act`` is a no-op: the port runs on one device so far.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def shard_act(x: torch.Tensor, *spec) -> torch.Tensor:
    """Activation sharding hint; a no-op on one device."""
    return x


# -- initializers ----------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def fan_in_init(gen, shape, fan_in: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, shape, fan_in ** -0.5, dtype, device)


# -- norms ------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # (1 + scale)


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


# -- embeddings / unembedding -------------------------------------------------------
def embed_init(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": normal_init(gen, (vocab, d), 0.02, dtype, device)}


def embed_lookup(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table cast to ``dtype``. Gathers first and casts the
    gathered rows: the same values as the reference's cast-then-take, without
    a second copy of the (V, d) table."""
    return F.embedding(tokens, params["table"]).to(dtype)


def unembed_logits(params: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """Tied unembedding: ``x @ table.T`` in ``dtype``."""
    return torch.matmul(x, params["table"].to(dtype).t())


# -- dense / MLP ------------------------------------------------------------------
def linear_init(gen, d_in: int, d_out: int, dtype, device,
                bias: bool = False) -> dict:
    p = {"w": fan_in_init(gen, (d_in, d_out), d_in, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(params: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    y = x @ params["w"].to(dtype)
    if "b" in params:
        y = y + params["b"].to(dtype)
    return y


def mlp_init(gen, d: int, ff: int, act: str, dtype, device) -> dict:
    if act != "silu":
        raise NotImplementedError(
            f"act={act!r}: the port carries the SwiGLU MLP so far")
    return {
        "gate": fan_in_init(gen, (d, ff), d, dtype, device),
        "up": fan_in_init(gen, (d, ff), d, dtype, device),
        "down": fan_in_init(gen, (ff, d), ff, dtype, device),
    }


def mlp_apply(params: dict, x: torch.Tensor, act: str, dtype) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * (x W_up)) W_down``."""
    if act != "silu":
        raise NotImplementedError(
            f"act={act!r}: the port carries the SwiGLU MLP so far")
    g = x @ params["gate"].to(dtype)
    u = x @ params["up"].to(dtype)
    return (F.silu(g) * u) @ params["down"].to(dtype)


# -- rotary position embeddings -----------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(
    positions: torch.Tensor,       # (B, S) int
    head_dim: int,
    theta: float,
    mrope_sections: Sequence[int] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin), each (B, S, head_dim//2), fp32."""
    if mrope_sections:
        raise NotImplementedError(
            "M-RoPE comes with the qwen2-vl slice (ROADMAP.md, Queue A)")
    freqs = rope_freqs(head_dim, theta, positions.device)     # (half,)
    angles = positions.float()[..., None] * freqs             # (B, S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2). Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# -- loss --------------------------------------------------------------------------
def softmax_xent(
    logits: torch.Tensor,   # (B, S, V)
    labels: torch.Tensor,   # (B, S) int32 or int64
    valid: Optional[torch.Tensor] = None,
    mode: str = "gather",
) -> torch.Tensor:
    """Mean cross-entropy in fp32 (max-shifted log-sum-exp; the gold logit
    taken by gather). ``mode="onehot"`` is a sharded-vocab lever of the
    reference and gives the same value on one device."""
    if mode not in ("gather", "onehot"):
        raise ValueError(f"unknown xent mode {mode!r}")
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if valid is not None:
        v = valid.float()
        return (nll * v).sum() / v.sum().clamp_min(1.0)
    return nll.mean()

