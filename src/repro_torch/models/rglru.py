"""Griffin recurrent block with RG-LRU (recurrentgemma-2b, arXiv:2402.19427).

The port's counterpart of the reference's ``models/rglru.py``. Block: x ->
[gate branch: linear -> GeLU] * [recurrent branch: linear -> causal conv
-> RG-LRU] -> output linear, with

    r_t = sigmoid(W_r x_t + b_r),  i_t = sigmoid(W_i x_t + b_i),
    a_t = exp(-c * softplus(lam) * r_t)                          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).

The two gate products stay fp32 GEMMs. The gates, the recurrence and the
output product ``h.to(dtype) * gate`` run through ``ops.rglru_scan_gated``:
one CUDA kernel launch a layer on the card, the plain version of
``kernels/ref.py`` on the CPU. The prefill forward runs it once over the
whole sequence (the reference runs an associative scan there: the same
function, summed in another order); each decode step runs it with S = 1
from the carried state. The kernel is forward-only: training through it
raises on the card.

Cast points follow the reference, since bf16 parity depends on them: the
branch inputs and the conv output are in the compute dtype, the gates and
``h`` in fp32, ``y = h.to(dtype) * gate``. GeLU is the tanh form.

Decode keeps O(1) state per token: ``h`` (B, w) in fp32 and the conv tail
(B, cw-1, w) in the compute dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv, fan_in_init, gelu, shard_act

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor        # (B, w) fp32
    conv: torch.Tensor     # (B, cw-1, w), compute dtype


def rglru_init(gen: torch.Generator, d: int, w: int, conv_width: int, dtype,
               device) -> dict:
    """The reference's init rules: fan-in normal projections and conv, zero
    biases, and ``lam`` set so that ``a^c`` spreads over [0.9, 0.999]."""
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, w, dtype=torch.float32, device=device)) / _C))
    return {
        "wx": fan_in_init(gen, (d, w), d, dtype, device),       # recurrent in
        "wy": fan_in_init(gen, (d, w), d, dtype, device),       # gate in
        "conv_w": fan_in_init(gen, (conv_width, w), conv_width, dtype,
                              device),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_r": fan_in_init(gen, (w, w), w, dtype, device),      # recurrence gate
        "w_i": fan_in_init(gen, (w, w), w, dtype, device),      # input gate
        "b_r": torch.zeros((w,), dtype=dtype, device=device),
        "b_i": torch.zeros((w,), dtype=dtype, device=device),
        "lam": lam.to(dtype),
        "wo": fan_in_init(gen, (w, d), w, dtype, device),
    }


def _recurrence(params: dict, xr: torch.Tensor, gate: torch.Tensor,
                h0=None):
    """The gate products stay fp32 GEMMs; the gates, the recurrence and
    ``h.to(dtype) * gate`` are one ``ops.rglru_scan_gated`` call over
    (B, S, w) inputs. Returns ``(y, h_S)``."""
    xf = xr.float()
    return ops.rglru_scan_gated(
        xf @ params["w_r"].float(), xf @ params["w_i"].float(),
        params["b_r"].float(), params["b_i"].float(), params["lam"].float(),
        xr, gate, h0=h0, return_state=True)


def rglru_apply(params: dict, x: torch.Tensor, *, dtype) -> torch.Tensor:
    """Train/prefill forward: x (B, S, d) -> (B, S, d)."""
    xr = shard_act(x @ params["wx"].to(dtype), "batch", None, "model")
    xr = causal_conv(xr, params["conv_w"].to(dtype), params["conv_b"].to(dtype))
    gate = gelu(x @ params["wy"].to(dtype))
    y, _ = _recurrence(params, xr, gate)
    y = shard_act(y, "batch", None, "model")
    return y @ params["wo"].to(dtype)


def rglru_init_state(batch: int, w: int, conv_width: int, dtype, device
                     ) -> RGLRUState:
    """The state before the first token: zeros."""
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_width - 1, w), dtype=dtype,
                         device=device),
    )


def rglru_decode(params: dict, x: torch.Tensor, state: RGLRUState, *, dtype
                 ) -> Tuple[torch.Tensor, RGLRUState]:
    """One token: x (B, 1, d) -> (out (B, 1, d), the next state)."""
    xr = x[:, 0] @ params["wx"].to(dtype)                     # (B, w)
    win = torch.cat([state.conv, xr[:, None]], dim=1)         # (B, cw, w)
    xr_c = (torch.einsum("bcw,cw->bw", win, params["conv_w"].to(dtype))
            + params["conv_b"].to(dtype))
    gate = gelu(x[:, 0] @ params["wy"].to(dtype))
    y, h = _recurrence(params, xr_c[:, None], gate[:, None], h0=state.h)
    out = y @ params["wo"].to(dtype)                          # (B, 1, d)
    return out, RGLRUState(h=h, conv=win[:, 1:])
