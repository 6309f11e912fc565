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

from repro_torch.configs.base import MAMBA, RGLRU, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.ssm import MambaState
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
    per-pattern-position states stacked over the blocks, ``tail`` a list of
    per-layer states, ``pos`` a scalar) -> the port's, one state per layer
    in schedule order: a ``KVCache`` for an attention layer, a
    ``MambaState`` or ``RGLRUState`` (``h``, ``conv``) for a Mamba or
    RG-LRU layer. Read by attribute, so the reference's NamedTuples pass as
    they are. A ring (wrapped or not) converts when its ``slot_pos`` is
    what writing position ``p`` at slot ``p % C`` leaves; any other layout
    raises."""
    dev = resolve_device(device)
    to_t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    pattern, nb, tail = cfg.scan_split()
    pos = int(np.asarray(state.pos))
    per_layer = [(spec, state.blocks[i], bi) for bi in range(nb)
                 for i, spec in enumerate(pattern)]
    per_layer += [(spec, st, None) for spec, st in zip(tail, state.tail)]
    layers = []
    for spec, st, bi in per_layer:
        def take(a):
            a = np.asarray(a)
            return a if bi is None else a[bi]

        if spec.mixer in (MAMBA, RGLRU):
            kind = MambaState if spec.mixer == MAMBA else RGLRUState
            layers.append(kind(h=to_t(take(st.h)), conv=to_t(take(st.conv))))
            continue
        k, v, slot_pos = take(st.k), take(st.v), take(st.slot_pos)
        # The port's ring keeps no slot_pos: slot s must hold the largest
        # position p < pos with p = s (mod C), or -1 if there is none.
        C = slot_pos.shape[0]
        want = (pos - 1) - (pos - 1 - np.arange(C)) % C
        want = np.where(want >= 0, want, -1)
        if not np.array_equal(slot_pos, want):
            raise NotImplementedError(
                f"a reference ring whose slots, wrapped or not, do not hold "
                f"the positions that writing position p at slot p % {C} "
                f"leaves after {pos} tokens (slot_pos {slot_pos.tolist()}): "
                f"the port's ring keeps no slot_pos and reads positions from "
                f"pos alone")
        layers.append(KVCache(k=to_t(k), v=to_t(v)))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"state holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return DecodeState(layers=layers, pos=pos)
