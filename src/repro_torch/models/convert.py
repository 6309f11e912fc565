"""Parameter and decode-state conversion between the reference's JAX
pytrees and the port.

The reference stacks each block-pattern position's params over a leading
``num_blocks`` axis (``params["blocks"]["l{i}"]``, scanned by the stack)
and keeps the remainder layers in ``params["tail"]``. The port keeps one
dict per layer, in schedule order, in ``params["layers"]``. Both functions
here take and give NumPy arrays on the reference side (the caller moves
them in and out of JAX), so this module needs neither package's arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import DecodeState


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map(fn, [t[i] for t in trees]) for i in range(len(first))]
    return fn(trees)


def from_reference(tree: Dict[str, Any], cfg: ModelConfig, *,
                   device="cuda") -> Dict[str, Any]:
    """Reference pytree (NumPy leaves) -> port params (tensors on
    ``device``; every leaf is copied, dtypes are kept)."""
    dev = resolve_device(device)
    to_t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    pattern, nb, tail = cfg.scan_split()
    layers = []
    for bi in range(nb):
        for i in range(len(pattern)):
            layers.append(_map(lambda a: to_t(np.asarray(a)[bi]),
                               tree["blocks"][f"l{i}"]))
    layers.extend(_map(to_t, layer) for layer in tree["tail"])
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    out = {"embed": _map(to_t, tree["embed"]),
           "final_norm": _map(to_t, tree["final_norm"]),
           "layers": layers}
    if "lm_head" in tree:
        out["lm_head"] = _map(to_t, tree["lm_head"])
    return out


def to_reference(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Port params -> reference pytree with NumPy leaves (blocks restacked
    over their leading axis)."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    pattern, nb, tail = cfg.scan_split()
    layers = params["layers"]
    out: Dict[str, Any] = {"embed": _map(to_np, params["embed"]),
                           "final_norm": _map(to_np, params["final_norm"])}
    if nb > 0:
        out["blocks"] = {
            f"l{i}": _zip_map(
                lambda ts: np.stack([to_np(t) for t in ts]),
                [layers[bi * len(pattern) + i] for bi in range(nb)])
            for i in range(len(pattern))
        }
    out["tail"] = [_map(to_np, layer) for layer in layers[nb * len(pattern):]]
    if "lm_head" in params:
        out["lm_head"] = _map(to_np, params["lm_head"])
    return out


def decode_state_from_reference(state, cfg: ModelConfig, *,
                                device="cuda") -> DecodeState:
    """Reference ``DecodeState`` (NumPy leaves: ``blocks`` a tuple of
    ``KVCache`` stacked over the blocks, ``tail`` a list of ``KVCache``,
    ``pos`` a scalar) -> the port's, one cache per layer in schedule order.
    Read by attribute, so the reference's NamedTuples pass as they are."""
    dev = resolve_device(device)
    to_t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    pattern, nb, tail = cfg.scan_split()
    pos = int(np.asarray(state.pos))
    caches = [tuple(np.asarray(a)[bi] for a in (c.k, c.v, c.slot_pos))
              for bi in range(nb) for c in state.blocks[:len(pattern)]]
    caches += [tuple(np.asarray(a) for a in (c.k, c.v, c.slot_pos))
               for c in state.tail]
    layers = []
    for k, v, slot_pos in caches:
        # The port's cache keeps position p in slot p: a wrapped ring has
        # no port counterpart yet.
        if not np.array_equal(slot_pos[:pos], np.arange(pos)):
            raise NotImplementedError(
                "a reference cache whose ring has wrapped: local-window "
                "decode comes with the gemma3 and recurrentgemma slices "
                "(ROADMAP.md, Queue A item 9)")
        layers.append(KVCache(k=to_t(k), v=to_t(v)))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"state holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return DecodeState(layers=layers, pos=pos)
