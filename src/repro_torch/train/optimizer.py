"""AdamW + warmup-cosine schedule, from scratch (no ``torch.optim``).

Moments are fp32 trees mirroring the params. Unlike the reference's pure
functions, ``adamw_update`` updates params and moments **in place** (under
``torch.no_grad``): at full width a second copy of the fp32 params and both
moments would cost another 12 GB of device memory per step.
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


def _zeros_like_tree(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return [_zeros_like_tree(v) for v in tree]


def init_opt_state(params: Any) -> Dict[str, Any]:
    return {"mu": _zeros_like_tree(params), "nu": _zeros_like_tree(params),
            "step": 0}


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


@torch.no_grad()
def adamw_update(
    grads: List[torch.Tensor],
    opt_state: Dict[str, Any],
    params: Any,
    cfg: OptConfig,
) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step. ``grads`` are in ``leaves(params)`` order. Params
    and moments are updated in place and returned."""
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
    for p, g, mu, nu in zip(leaves(params), grads, leaves(opt_state["mu"]),
                            leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square(), alpha=1 - b2)
        ref = p.float()
        delta = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps) + cfg.weight_decay * ref
        p.copy_(ref - lr * delta)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
