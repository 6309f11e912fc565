"""Gradient compression for the data-parallel reduction.

Two schemes, composable with the train step:

* **bf16 reduction** — cast grads to bf16 before the DP all-reduce, halving
  collective bytes; the optimizer runs on the fp32 upcast.
* **int8 + error feedback** — per-leaf symmetric int8 quantization with a
  persistent residual (error feedback), so the quantization error is
  replayed into the next step instead of lost; 4× fewer bytes.

Every function takes and gives lists of tensors in ``leaves(params)``
order (the order of the grads ``make_loss_and_grads`` returns). The int8
scale is per leaf of the reference's tree, where each block-pattern
position stacks its layers into one leaf: ``groups`` lists the port's
leaves that share a scale (``models.convert.reference_leaf_groups``;
default, one each). There is one device today, so nothing is reduced: the
step applies what a receiving replica would reconstruct, which keeps
every replica bit-identical.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def to_bf16(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [g.to(torch.bfloat16) for g in grads]


def from_bf16(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [g.to(torch.float32) for g in grads]


def init_ef_state(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Error-feedback residuals (fp32, the params' shapes)."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def _quantize(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns ``(q, scale)``."""
    gf = g.float()
    scale = gf.abs().max().clamp_min(1e-12) / 127.0
    return _quantize(gf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads: Sequence[torch.Tensor], ef: Sequence[torch.Tensor],
                groups: Optional[Sequence[Sequence[int]]] = None,
                ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                           List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 compression. Returns ``(q, deq, new_ef)``: the
    ``(q, scale)`` pair of each leaf (the leaves of a group share their
    scale), the grads they decompress to (what the optimizer is fed), and
    the new residuals."""
    targets = [g.float() + r for g, r in zip(grads, ef)]
    scales: List[torch.Tensor] = [None] * len(targets)  # type: ignore[list-item]
    for group in groups if groups is not None else [[i] for i in range(len(targets))]:
        amax = torch.stack([targets[i].abs().max() for i in group]).max()
        for i in group:
            scales[i] = amax.clamp_min(1e-12) / 127.0
    qs, deqs, new_ef = [], [], []
    for target, s in zip(targets, scales):
        q = _quantize(target, s)
        deq = dequantize_int8(q, s)
        qs.append((q, s))
        deqs.append(deq)
        new_ef.append(target - deq)
    return qs, deqs, new_ef


def compressed_bytes(grads: Sequence[torch.Tensor], scheme: str,
                     groups: Optional[Sequence[Sequence[int]]] = None) -> int:
    """Bytes on the wire for the DP reduction under a scheme (one int8
    scale a group)."""
    n = sum(g.numel() for g in grads)
    if scheme == "fp32":
        return 4 * n
    if scheme == "bf16":
        return 2 * n
    if scheme == "int8":
        return n + 4 * (len(groups) if groups is not None else len(grads))
    raise ValueError(scheme)
