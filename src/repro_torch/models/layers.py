"""Shared neural building blocks (plain functions on tensors, dict params).

Conventions follow the reference package:
  * params live in ``param_dtype`` (fp32), compute casts to ``dtype``
    (bf16); norms and the softmax accumulate in fp32;
  * activation sharding hints go through ``shard_act`` at the reference's
    call sites: a redistribution on a DTensor (the dry run's pass B), a
    no-op on a plain tensor.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


BATCH_AXES = ("pod", "data")


def shard_act(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` hint. On a DTensor:
    redistributed so that dim i is sharded over ``spec[i]`` (an axis name,
    a tuple of them, ``"batch"`` for the mesh's batch axes, or None) and
    replicated over every other mesh axis (a partial sum is reduced).
    Axes the mesh lacks are dropped, and so are axes that do not divide
    the dim: GSPMD pads such a dim, DTensor cannot reshape an uneven shard
    (phi4's 24 heads over 16), so the dim stays replicated there. On a
    plain tensor: returned as it is, after one type check."""
    if type(x) is torch.Tensor or not hasattr(x, "device_mesh"):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    where = {}
    for i, s in enumerate(spec):
        axes = (BATCH_AXES if s == "batch" else (s,) if isinstance(s, str)
                else tuple(s or ()))
        axes = [a for a in axes
                if a in names and mesh.size(names.index(a)) > 1]
        n = 1
        for a in axes:
            n *= mesh.size(names.index(a))
        if axes and x.shape[i] % n == 0:
            where.update({a: i for a in axes})
    return x.redistribute(mesh, [Shard(where[a]) if a in where else
                                 Replicate() for a in names])


# -- initializers ----------------------------------------------------------------
def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """Normal draws from ``gen`` times ``scale``. On the meta device (the
    dry run's abstract params, ``Model.abstract_params``) only the shape
    and dtype exist: no number is drawn and ``gen`` is not read."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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


def layernorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm with scale and bias, computed in fp32 (the biased
    variance, as ``jnp.var``)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


# -- embeddings / unembedding -------------------------------------------------------
def embed_init(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": normal_init(gen, (vocab, d), 0.02, dtype, device)}


def embed_lookup(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table cast to ``dtype``. Gathers first and casts the
    gathered rows: the same values as the reference's cast-then-take, without
    a second copy of the (V, d) table."""
    if tokens.device.type == "meta":
        # the dry run: a lookup that a vocab-sharded DTensor can run
        from repro_torch.kernels import meta
        out = meta.embedding(tokens, params["table"])
    else:
        out = F.embedding(tokens, params["table"])
    return shard_act(out.to(dtype), "batch", None, None)


def unembed_logits(params: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """Tied unembedding: ``x @ table.T`` in ``dtype``."""
    return shard_act(torch.matmul(x, params["table"].to(dtype).t()),
                     "batch", None, "model")


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


GLU_ACTS = ("silu", "gelu_glu")   # SwiGLU / GeGLU (gemma family)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default (not torch's erf
    form)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen, d: int, ff: int, act: str, dtype, device) -> dict:
    if act in GLU_ACTS:
        return {
            "gate": fan_in_init(gen, (d, ff), d, dtype, device),
            "up": fan_in_init(gen, (d, ff), d, dtype, device),
            "down": fan_in_init(gen, (ff, d), ff, dtype, device),
        }
    if act != "gelu":
        raise ValueError(f"unknown MLP activation {act!r}")
    return {
        "fc1": fan_in_init(gen, (d, ff), d, dtype, device),
        "fc1_b": torch.zeros((ff,), dtype=dtype, device=device),
        "fc2": fan_in_init(gen, (ff, d), ff, dtype, device),
        "fc2_b": torch.zeros((d,), dtype=dtype, device=device),
    }


def mlp_apply(params: dict, x: torch.Tensor, act: str, dtype) -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU (``"gelu_glu"``):
    ``(act(x W_gate) * (x W_up)) W_down``; or the plain GELU MLP with
    biases (``"gelu"``, whisper): ``gelu(x fc1 + fc1_b) fc2 + fc2_b``."""
    if act in GLU_ACTS:
        g = x @ params["gate"].to(dtype)
        u = x @ params["up"].to(dtype)
        nl = F.silu if act == "silu" else gelu
        h = shard_act(nl(g) * u, "batch", None, "model")
        return h @ params["down"].to(dtype)
    if act != "gelu":
        raise ValueError(f"unknown MLP activation {act!r}")
    h = gelu(x @ params["fc1"].to(dtype) + params["fc1_b"].to(dtype))
    h = shard_act(h, "batch", None, "model")
    return h @ params["fc2"].to(dtype) + params["fc2_b"].to(dtype)


# -- temporal conv ----------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv over seq: x (B, S, c), w (cw, c), b (c,).
    A cross-correlation with cw-1 zeros on the left, as the reference's
    ``conv_general_dilated`` with ``feature_group_count=c`` (no flip)."""
    if x.device.type == "meta":
        # the dry run: a conv whose channels a DTensor can shard
        from repro_torch.kernels import meta
        return meta.causal_conv(x, w, b)
    cw, c = w.shape
    xt = F.pad(x.transpose(1, 2), (cw - 1, 0))            # (B, c, S+cw-1)
    y = F.conv1d(xt, w.t().unsqueeze(1), groups=c)        # (B, c, S)
    return y.transpose(1, 2) + b


# -- rotary position embeddings -----------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(
    positions: torch.Tensor,       # (B, S) int, or (B, S, 3) for M-RoPE
    head_dim: int,
    theta: float,
    mrope_sections: Sequence[int] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin), each (B, S, head_dim//2), fp32.

    M-RoPE (Qwen2-VL, arXiv:2409.12191): the rotary frequency dims are
    split into (t, h, w) sections; each section takes its angle from the
    matching coordinate of the 3-D position ids."""
    freqs = rope_freqs(head_dim, theta, positions.device)     # (half,)
    pos = positions.float()
    if positions.dim() == 3 and mrope_sections:
        if sum(mrope_sections) != head_dim // 2:
            raise ValueError(f"mrope sections {tuple(mrope_sections)} != "
                             f"head_dim/2 {head_dim // 2}")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(pos[..., i:i + 1] * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)                     # (B, S, half)
    else:
        angles = pos[..., None] * freqs                       # (B, S, half)
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
    # the hints keep the logits vocab-sharded on a DTensor, as GSPMD does
    m = shard_act(lf.amax(dim=-1, keepdim=True).detach(), "batch", None, None)
    shifted = shard_act(lf - m, "batch", None, "model")
    lse = torch.log(shard_act(torch.exp(shifted).sum(dim=-1), "batch", None))
    if shifted.device.type == "meta":
        # the dry run: a masked gather that a vocab-sharded DTensor can run
        from repro_torch.kernels import meta
        gold = meta.take_labels(shifted, labels)
    else:
        gold = torch.gather(shifted, -1, labels.long()[..., None])[..., 0]
    nll = lse - shard_act(gold, "batch", None)
    if valid is not None:
        v = valid.float()
        return (nll * v).sum() / v.sum().clamp_min(1.0)
    return nll.mean()

