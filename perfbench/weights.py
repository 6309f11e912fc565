"""Model weights made from the seed, on the device, in one draw.

Every leaf of the port's parameter tree gets a slice of one flat fp32
buffer, filled by a single ``normal_`` call from a ``torch.Generator`` on
the device and then scaled or overwritten leaf by leaf by the rule that
the configuration file's ``init`` block names for the leaf's key. The
same seed and tree give the same numbers, so the plain reference makes
its own copy again from the seed and takes nothing from the program.

Rules (``[kind, arg...]``):
  ``normal s``      the draw times ``s``
  ``fan_in k``      the draw times (product of the first ``k`` dims)^-1/2
  ``fan_in_at i``   the draw times (size of dim ``i``)^-1/2 (stacked
                    experts' ``(E, d, ff)`` and ``(E, ff, d)`` at ``i`` 1)
  ``zeros``/``ones`` constants
  ``s4d_real``      ``log(1..n)`` along the last dim (Mamba's A_log)
  ``dt_log_uniform lo hi``  softplus^-1 of dt drawn log-uniform in
                    [lo, hi], through the normal CDF of the draw (Mamba's
                    dt bias)
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import torch

ALIGN = 64          # elements: every leaf starts on a 256-byte boundary


def leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaf_paths(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def _set(tree: Any, path: str, value: Any) -> None:
    *head, last = path.split(".")
    node = tree
    for k in head:
        node = node[int(k)] if isinstance(node, list) else node[k]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _empty_like_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _empty_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_empty_like_tree(v) for v in tree]
    return None


def rule_for(path: str, rules: Dict[str, list]) -> list:
    key = path.rsplit(".", 1)[-1]
    if key in rules:
        return rules[key]
    if "*" in rules:
        return rules["*"]
    raise KeyError(f"no init rule for leaf {path!r}")


def _fill(x: torch.Tensor, rule: list) -> None:
    kind, *arg = rule
    if kind == "normal":
        x.mul_(float(arg[0]))
    elif kind == "fan_in":
        fan = math.prod(x.shape[:int(arg[0])])
        x.mul_(fan ** -0.5)
    elif kind == "fan_in_at":
        x.mul_(x.shape[int(arg[0])] ** -0.5)
    elif kind == "zeros":
        x.zero_()
    elif kind == "ones":
        x.fill_(1.0)
    elif kind == "s4d_real":
        n = x.shape[-1]
        x.copy_(torch.log(torch.arange(1, n + 1, dtype=x.dtype,
                                       device=x.device)).expand_as(x))
    elif kind == "dt_log_uniform":
        lo, hi = math.log(float(arg[0])), math.log(float(arg[1]))
        u = 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
        dt = torch.exp(lo + u * (hi - lo))
        x.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown init rule {rule!r}")


def tree_from_shapes(shapes: Dict[str, tuple]) -> Any:
    """A tree of ``SimpleNamespace(shape=...)`` leaves from ``{path:
    shape}``; a numeric path part makes a list."""
    tree: Dict = {}
    for path, shape in shapes.items():
        node, parts = tree, path.split(".")
        for i, k in enumerate(parts):
            last = i == len(parts) - 1
            new = (SimpleNamespace(shape=tuple(shape)) if last else
                   [] if parts[i + 1].isdigit() else {})
            if isinstance(node, list):
                k = int(k)
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = new
                node = node[k]
            else:
                node = node.setdefault(k, new)
    return tree


def make(shapes: Any, rules: Dict[str, list], seed: int, device
         ) -> Tuple[Any, torch.Tensor]:
    """``(params, flat)``: a tree shaped like ``shapes`` (any tree whose
    leaves have ``.shape``) of fp32 tensors that are views of ``flat``."""
    paths = leaf_paths(shapes)
    offs, at = [], 0
    for _, leaf in paths:
        offs.append(at)
        n = math.prod(leaf.shape)
        at += (n + ALIGN - 1) // ALIGN * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.empty(at, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    params = _empty_like_tree(shapes)
    for (path, leaf), o in zip(paths, offs):
        x = flat[o:o + math.prod(leaf.shape)].view(tuple(leaf.shape))
        _fill(x, rule_for(path, rules))
        _set(params, path, x.detach())
    return params, flat
