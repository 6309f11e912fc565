"""Mixture-of-Experts FFN: top-k routing, capacity-based sort and gather
dispatch, shared experts (Qwen-MoE style), the Switch load-balancing loss.

The same function as the reference's ``repro/models/moe.py``: routing per
batch row on fp32 logits (padded experts masked out with -1e30), softmax,
top-k, a stable sort of the (token, choice) entries by expert id so that
earlier tokens win capacity, ``C = max(1, int(capacity_factor * top_k * S /
n_real + 0.5))`` slots an expert, dropped choices sent to a sentinel slot
that gives zeros. Expert inputs are gathered into an ``(E, C, d)`` buffer a
row and the expert FFNs run as batched einsums over all E + pad physical
experts; the reference computes them outside any Pallas kernel too.

Ties are broken as the reference breaks them: ``jax.lax.top_k`` puts the
lower expert index first among equal probabilities, which a stable
descending sort gives (``torch.topk`` promises no order on ties), and the
expert-id sort is ``torch.sort(stable=True)``, the reference's
``argsort(stable=True)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import fan_in_init, shard_act


def moe_init(gen: torch.Generator, d: int, num_experts: int, moe_ff: int,
             num_shared: int, dtype, device, expert_pad: int = 0) -> dict:
    """Params in the reference's layout: the expert axis holds all
    ``num_experts + expert_pad`` physical experts."""
    ep = num_experts + expert_pad
    p = {
        "router": fan_in_init(gen, (d, ep), d, dtype, device),
        "gate": fan_in_init(gen, (ep, d, moe_ff), d, dtype, device),
        "up": fan_in_init(gen, (ep, d, moe_ff), d, dtype, device),
        "down": fan_in_init(gen, (ep, moe_ff, d), moe_ff, dtype, device),
    }
    if num_shared > 0:
        ff_sh = num_shared * moe_ff
        p["shared_gate"] = fan_in_init(gen, (d, ff_sh), d, dtype, device)
        p["shared_up"] = fan_in_init(gen, (d, ff_sh), d, dtype, device)
        p["shared_down"] = fan_in_init(gen, (ff_sh, d), ff_sh, dtype, device)
    return p


def _route(
    logits: torch.Tensor,      # (B, S, E) fp32
    top_k: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row slot assignment.

    Returns ``idx_table`` (B, E*C) int32, the token feeding each expert
    slot (S, the sentinel, for an empty slot); ``slot_of`` (B, S, k) int32,
    the slot of each (token, choice), E*C when dropped; ``weight`` (B, S,
    k) fp32, the router probability of each choice; ``probs`` (B, S, E)
    fp32, for the aux loss."""
    B, S, E = logits.shape
    k, C = top_k, capacity
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    # top_k as jax.lax.top_k: descending, lower index first on ties.
    srt_w, srt_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = srt_w[..., :k], srt_e[..., :k]

    eid = top_e.reshape(B, S * k)
    # stable sort by expert id so that earlier tokens win capacity
    eid_sorted, order = torch.sort(eid, dim=-1, stable=True)
    tok_sorted = order // k

    # position within the expert's segment
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(eid_sorted, experts, side="left")
    start_of = torch.gather(seg_start, 1, eid_sorted)
    pos = torch.arange(S * k, device=dev)[None, :] - start_of
    dest = torch.where(pos < C, eid_sorted * C + pos, E * C)  # sentinel E*C

    # expert slot -> token (the sentinel column, written by every dropped
    # entry, is cut off)
    # (``new_*`` of ``dest``: a DTensor's, the dry run's pass B, too)
    idx_table = dest.new_full((B, E * C + 1), S, dtype=torch.int64)
    idx_table.scatter_(1, dest, tok_sorted)
    idx_table = idx_table[:, :E * C].to(torch.int32)

    # (token, choice) -> slot: ``order`` is a permutation of each row
    slot_of = dest.new_empty((B, S * k), dtype=torch.int64)
    slot_of.scatter_(1, order, dest)
    return idx_table, slot_of.to(torch.int32).reshape(B, S, k), top_w, probs


def load_balance_loss(probs: torch.Tensor, slot_of: torch.Tensor,
                      num_experts: int, top_k: int, capacity: int
                      ) -> torch.Tensor:
    """Switch-Transformer aux loss: ``E * sum_e f_e * P_e``, E the physical
    experts (``probs``' last axis, as in the reference)."""
    B, S, E = probs.shape
    served = (slot_of < E * capacity).float()                # (B, S, k)
    expert_of_slot = torch.clamp(slot_of.long() // capacity, 0, E - 1)
    onehot = F.one_hot(expert_of_slot, E).float() * served[..., None]
    f = onehot.sum(dim=(1, 2)) / max(S * top_k, 1)           # token fraction
    p = probs.mean(dim=1)                                    # prob fraction
    return (f * p).sum(dim=-1).mean() * E


def moe_apply(
    params: dict,
    x: torch.Tensor,           # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float,
    dtype,
    norm_topk: bool = False,
    num_real_experts: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, d) in x's dtype, aux loss fp32 scalar)."""
    B, S, d = x.shape
    E = params["router"].shape[1]      # physical (possibly padded) experts
    n_real = num_real_experts or E
    C = max(1, int(capacity_factor * top_k * S / max(n_real, 1) + 0.5))

    router_logits = x.float() @ params["router"].float()     # (B, S, E)
    if n_real < E:                     # padded experts never route
        pad = torch.arange(E, device=x.device) >= n_real
        router_logits = router_logits.masked_fill(pad, -1e30)
    idx_table, slot_of, top_w, probs = _route(router_logits, top_k, C)
    aux = load_balance_loss(probs, slot_of, E, top_k, C)

    if norm_topk:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # dispatch: gather the expert inputs (sentinel row S gives zeros)
    xp = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    xe = torch.gather(xp, 1, idx_table.long()[..., None].expand(B, E * C, d))
    xe = shard_act(xe.reshape(B, E, C, d), "batch", "model", None, None)

    g = torch.einsum("becd,edf->becf", xe, params["gate"].to(dtype))
    u = torch.einsum("becd,edf->becf", xe, params["up"].to(dtype))
    h = F.silu(g) * u
    ye = torch.einsum("becf,efd->becd", h, params["down"].to(dtype))
    ye = shard_act(ye, "batch", "model", None, None)

    # combine: each token's k slot outputs, weighted and summed
    yp = torch.cat([ye.reshape(B, E * C, d), ye.new_zeros((B, 1, d))], dim=1)
    slot_safe = torch.clamp(slot_of.long(), max=E * C).reshape(B, S * top_k)
    picked = torch.gather(yp, 1, slot_safe[..., None].expand(B, S * top_k, d))
    picked = picked.reshape(B, S, top_k, d)
    out = (picked * top_w[..., None].to(picked.dtype)).sum(dim=2)

    # shared experts: the always-on dense path (Qwen-MoE)
    if "shared_gate" in params:
        sg = x @ params["shared_gate"].to(dtype)
        su = x @ params["shared_up"].to(dtype)
        sh = shard_act(F.silu(sg) * su, "batch", None, "model")
        out = out + sh @ params["shared_down"].to(dtype)
    return out.to(x.dtype), aux
