"""Mamba-1 selective SSM block (falcon-mamba-7b, arXiv:2410.05355).

The port's counterpart of the reference's ``models/ssm.py``, with its two
``ssm_impl`` values. "materialized" builds ``Abar`` and ``Bx`` (B, S,
d_inner, n) in device memory and runs the literal selective scan
(``ops.mamba_scan``, the counterpart of ``mamba_scan_pallas``), then the
skip and gate epilogue as separate ops. "fused", like the reference's
``_fused_chunk_scan``, discretizes inside the scan: ``ops.mamba_scan_fused``
takes the conv output, the ``dt_proj`` product and the ``x_proj`` output
and returns the layer's gated output in one kernel launch on the card
(the plain version of ``kernels/ref.py`` on the CPU). Every decode step
runs the fused entry with S = 1 from the carried state. Both entries are
differentiable: a train step's backward runs the literal or the fused
scan's backward kernel once a layer on the card (the reference leaves the
gradient of its scans to XLA's autodiff).

Cast points follow the reference, since bf16 parity depends on them: ``dt``
goes through softplus in the compute dtype and then to fp32; ``Bc``, ``Cc``
and the conv output ``xin`` are cast to fp32 where the scan's inputs are
built; the scan's output is rounded to the compute dtype before the skip.

Decode keeps O(1) state per token: the conv tail (B, cw-1, d_inner) in the
compute dtype and the SSM state (B, d_inner, n) in fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv, fan_in_init, shard_act

IMPLS = ("materialized", "fused")


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, d_inner, n) fp32
    conv: torch.Tensor     # (B, cw-1, d_inner), compute dtype


def mamba_init(gen: torch.Generator, d: int, d_inner: int, state: int,
               dt_rank: int, conv_width: int, dtype, device) -> dict:
    """The reference's init rules: fan-in normal projections and conv,
    zero conv bias, ``dt_bias = log(expm1(1e-2))``, S4D-real ``A_log =
    log(1..n)`` per channel, ``D = 1``."""
    A = torch.arange(1, state + 1, dtype=torch.float32,
                     device=device).repeat(d_inner, 1)
    return {
        "in_proj": fan_in_init(gen, (d, 2 * d_inner), d, dtype, device),
        "conv_w": fan_in_init(gen, (conv_width, d_inner), conv_width, dtype,
                              device),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": fan_in_init(gen, (d_inner, dt_rank + 2 * state), d_inner,
                              dtype, device),
        "dt_proj": fan_in_init(gen, (dt_rank, d_inner), dt_rank, dtype,
                               device),
        "dt_bias": torch.full((d_inner,), math.log(math.expm1(1e-2)),
                              dtype=torch.float32, device=device).to(dtype),
        "A_log": torch.log(A).to(dtype),
        "D": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": fan_in_init(gen, (d_inner, d), d_inner, dtype, device),
    }


def _projections(params: dict, xin: torch.Tensor, dtype):
    """From the conv output ``xin`` (..., di): the ``x_proj`` output
    ``proj`` (..., r+2n), whose last 2n columns are ``Bc`` and ``Cc``, and
    the ``dt_proj`` product ``dt_pre`` (..., di) before its bias."""
    n = params["A_log"].shape[1]
    r = params["dt_proj"].shape[0]
    proj = xin @ params["x_proj"].to(dtype)                 # (..., r+2n)
    dt_in = torch.split(proj, [r, n, n], dim=-1)[0]
    return proj, dt_in @ params["dt_proj"].to(dtype)


def discretize(dt_pre: torch.Tensor, dt_bias: torch.Tensor,
               A_log: torch.Tensor, proj: torch.Tensor, xin: torch.Tensor):
    """The literal scan's inputs ``Abar``, ``Bx`` (..., di, n) and ``Cc``
    (..., n), fp32 and contiguous, from the ``dt_proj`` product before its
    bias, the ``x_proj`` output (``Bc``, ``Cc`` its last 2n columns) and
    the conv output ``xin``."""
    dtype = xin.dtype
    n = A_log.shape[1]
    r = proj.shape[-1] - 2 * n
    Bc, Cc = proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(dt_pre + dt_bias.to(dtype)).float()     # (..., di)
    A = -torch.exp(A_log.float())                           # (di, n)
    Abar = torch.exp(dt[..., None] * A)
    Bx = dt[..., None] * Bc[..., None, :].float() * xin[..., None].float()
    return Abar, Bx, Cc.float().contiguous()


def _fused_scan(params: dict, xin, z, dtype, h0=None):
    """Discretization, scan and epilogue in one ``ops.mamba_scan_fused``
    call over (B, S, di) inputs; returns ``(y, h_S)``."""
    proj, dt_pre = _projections(params, xin, dtype)
    return ops.mamba_scan_fused(
        xin, dt_pre, params["dt_bias"].float(), params["A_log"].float(), proj,
        params["D"].float(), z, h0=h0, return_state=True)


def mamba_apply(params: dict, x: torch.Tensor, *, dtype,
                impl: str = "materialized") -> torch.Tensor:
    """Train/prefill forward over (B, S, d). The reference's ``ssm_chunk``
    has no counterpart: the kernels walk the whole sequence."""
    if impl not in IMPLS:
        raise ValueError(f"unknown ssm_impl {impl!r} (expected one of {IMPLS})")
    xz = x @ params["in_proj"].to(dtype)                    # (B, S, 2di)
    xin, z = xz.chunk(2, dim=-1)
    xin = shard_act(xin, "batch", None, "model")
    xin = F.silu(causal_conv(xin, params["conv_w"].to(dtype),
                             params["conv_b"].to(dtype)))
    if impl == "fused":
        y, _ = _fused_scan(params, xin, z, dtype)
    else:
        proj, dt_pre = _projections(params, xin, dtype)
        Abar, Bx, Cc = discretize(dt_pre, params["dt_bias"],
                                  params["A_log"], proj, xin)
        y = ops.mamba_scan(Abar, Bx, Cc).to(dtype)
        y = y + params["D"].to(dtype) * xin
        y = y * F.silu(z)
    y = shard_act(y, "batch", None, "model")
    return y @ params["out_proj"].to(dtype)


def mamba_init_state(batch: int, d_inner: int, state: int, conv_width: int,
                     dtype, device) -> MambaState:
    """The state before the first token: zeros."""
    return MambaState(
        h=torch.zeros((batch, d_inner, state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype,
                         device=device),
    )


def mamba_decode(params: dict, x: torch.Tensor, state: MambaState, *, dtype
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One token: x (B, 1, d) -> (out (B, 1, d), the next state)."""
    xz = x[:, 0] @ params["in_proj"].to(dtype)              # (B, 2di)
    xin, z = xz.chunk(2, dim=-1)
    # conv over [state, xin]
    win = torch.cat([state.conv, xin[:, None, :]], dim=1)   # (B, cw, di)
    w = params["conv_w"].to(dtype)                          # (cw, di)
    xin_c = F.silu(torch.einsum("bci,ci->bi", win, w)
                   + params["conv_b"].to(dtype))
    y, h = _fused_scan(params, xin_c[:, None], z[:, None], dtype,
                       h0=state.h)
    out = y @ params["out_proj"].to(dtype)                  # (B, 1, d)
    return out, MambaState(h=h, conv=win[:, 1:])
