"""AdamW + warmup-cosine schedule, from scratch (no ``torch.optim``).

Moments are fp32 trees mirroring the params. Unlike the reference's pure
functions, ``adamw_update`` updates params, moments and master weights **in
place** (under ``torch.no_grad``): at full width a second copy of the fp32
params and both moments would cost another 12 GB of device memory per step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree: Any) -> List[torch.Tensor]:
    """Tensor leaves of a nested dict/list tree, in a fixed order (dict keys
    sorted, as ``jax.tree`` flattens them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for v in tree for t in leaves(v)]


def lr_at(cfg: OptConfig, step: int) -> float:
    s = float(step)
    if s < cfg.warmup_steps:
        return cfg.peak_lr * min(s / max(cfg.warmup_steps, 1), 1.0)
    t = min(max((s - cfg.warmup_steps)
                / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * t))
    return cfg.peak_lr * cos


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return [_map_tree(fn, v) for v in tree]


def init_opt_state(params: Any, master_weights: bool = False) -> Dict[str, Any]:
    """``master_weights=True``: keep fp32 master copies in the optimizer
    state, so that the params can live in bf16 (the update is applied to
    the master and the param takes its cast)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    state = {"mu": _map_tree(zeros, params), "nu": _map_tree(zeros, params),
             "step": 0}
    if master_weights:
        state["master"] = _map_tree(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


@torch.no_grad()
def adamw_update(
    grads: List[torch.Tensor],
    opt_state: Dict[str, Any],
    params: Any,
    cfg: OptConfig,
) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step. ``grads`` are in ``leaves(params)`` order. Params,
    moments and (with ``"master"`` in ``opt_state``) master weights are
    updated in place and returned. With masters the update reads and
    writes the fp32 master and the param gets its cast, as in the
    reference."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    ps = leaves(params)
    masters = (leaves(opt_state["master"]) if "master" in opt_state
               else [None] * len(ps))
    for p, g, mu, nu, master in zip(ps, grads, leaves(opt_state["mu"]),
                                    leaves(opt_state["nu"]), masters):
        g = g.float() * scale
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square(), alpha=1 - b2)
        ref = master if master is not None else p.float()
        delta = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps) + cfg.weight_decay * ref
        new_master = ref - lr * delta
        if master is not None:
            master.copy_(new_master)
        p.copy_(new_master)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
