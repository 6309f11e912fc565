"""Parameter, train-state and decode-state conversion between the
reference's JAX pytrees and the port.

The reference stacks each block-pattern position's params over a leading
``num_blocks`` axis (``params["blocks"]["l{i}"]``, scanned by the stack)
and keeps the remainder layers in ``params["tail"]`` (gemma3-27b: 10
blocks of 6 layers and 2 tail layers). The port keeps one dict per layer,
in schedule order, in ``params["layers"]``. Leaves map by name, one to
one, whatever the layer holds: an MoE layer's ``router`` (d, E + pad), its
``gate`` / ``up`` (E + pad, d, f) and ``down`` (E + pad, f, d), and its
``shared_*`` experts keep the reference's shapes, padded experts
included. An encoder-decoder (whisper) stacks every encoder layer in
``enc_blocks`` and every decoder layer in ``dec_blocks``; the port keeps
each as a list of layers, LayerNorm and MLP biases included. The param and
decode-state functions take and give NumPy arrays on the reference side
(the caller moves them in and out of JAX), so this module needs neither
package's arrays; the train-state pair keeps tensors on both sides, since
NumPy has no bfloat16 (the checkpoint module writes either).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import MAMBA, RGLRU, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import EncDecState
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


_ENCDEC_STACKS = (("enc_blocks", "encoder_layers"), ("dec_blocks", "num_layers"))


def _first(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _unstack(tree: Dict[str, Any], cfg: ModelConfig, to_t) -> Dict[str, Any]:
    """Reference layout -> the port's per-layer list, each leaf through
    ``to_t`` (a stacked leaf indexed by its block first). An
    encoder-decoder's ``enc_blocks`` and ``dec_blocks`` are stacked over
    every layer; each becomes a list of layers."""
    if cfg.is_encdec:
        out = {k: _map(to_t, v) for k, v in tree.items()
               if k not in dict(_ENCDEC_STACKS)}
        for key, n_field in _ENCDEC_STACKS:
            n = getattr(cfg, n_field)
            held = _first(tree[key]).shape[0]
            if held != n:
                raise ValueError(f"{key} holds {held} layers, config "
                                 f"{cfg.name} has {n}")
            out[key] = [_map(lambda a: to_t(a[i]), tree[key])
                        for i in range(n)]
        return out
    pattern, nb, tail = cfg.scan_split()
    layers = []
    for bi in range(nb):
        for i in range(len(pattern)):
            layers.append(_map(lambda a: to_t(a[bi]), tree["blocks"][f"l{i}"]))
    # a checkpoint read without a like-tree has no empty tail
    layers.extend(_map(to_t, layer) for layer in tree.get("tail", []))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    out = {"embed": _map(to_t, tree["embed"]),
           "final_norm": _map(to_t, tree["final_norm"]),
           "layers": layers}
    if "lm_head" in tree:
        out["lm_head"] = _map(to_t, tree["lm_head"])
    return out


def _restack(params: Dict[str, Any], cfg: ModelConfig, leaf, stack
             ) -> Dict[str, Any]:
    """The port's per-layer list -> reference layout: each block-pattern
    position's layers stacked over a leading axis by ``stack`` (given the
    layers' leaves), every other leaf through ``leaf``. An
    encoder-decoder's layer lists are stacked whole."""
    if cfg.is_encdec:
        out = {k: _map(leaf, v) for k, v in params.items()
               if k not in dict(_ENCDEC_STACKS)}
        for key, _ in _ENCDEC_STACKS:
            out[key] = _zip_map(stack, params[key])
        return out
    pattern, nb, tail = cfg.scan_split()
    layers = params["layers"]
    out: Dict[str, Any] = {"embed": _map(leaf, params["embed"]),
                           "final_norm": _map(leaf, params["final_norm"])}
    if nb > 0:
        out["blocks"] = {
            f"l{i}": _zip_map(
                stack,
                [layers[bi * len(pattern) + i] for bi in range(nb)])
            for i in range(len(pattern))
        }
    out["tail"] = [_map(leaf, layer) for layer in layers[nb * len(pattern):]]
    if "lm_head" in params:
        out["lm_head"] = _map(leaf, params["lm_head"])
    return out


def from_reference(tree: Dict[str, Any], cfg: ModelConfig, *,
                   device="cuda") -> Dict[str, Any]:
    """Reference pytree (NumPy leaves) -> port params (tensors on
    ``device``; every leaf is copied, dtypes are kept)."""
    dev = resolve_device(device)
    return _unstack(tree, cfg,
                    lambda a: torch.tensor(np.asarray(a), device=dev))


def to_reference(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Port params -> reference pytree with NumPy leaves (blocks restacked
    over their leading axis)."""
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    return _restack(params, cfg, to_np,
                    lambda ts: np.stack([to_np(t) for t in ts]))


def reference_leaf_groups(params: Dict[str, Any], cfg: ModelConfig
                          ) -> List[List[int]]:
    """The port's leaves (indices into ``train.optimizer.leaves(params)``)
    grouped by the reference leaf that holds them: the layers of one
    block-pattern position share a stacked leaf; every other leaf is one of
    its own. Groups are in the reference's leaf order."""
    counter = itertools.count()

    def number(tree):        # each leaf's index, in ``leaves`` order
        if isinstance(tree, dict):
            return {k: number(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [number(v) for v in tree]
        return next(counter)

    groups: List[List[int]] = []

    def collect(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                collect(tree[k])
        elif isinstance(tree, list):
            for v in tree:
                collect(v)
        else:
            groups.append(list(tree) if isinstance(tree, tuple) else [tree])

    collect(_restack(number(params), cfg, lambda i: i, tuple))
    return groups


_OPT_TREES = ("mu", "nu", "master")


def _host_stack(ts: List[torch.Tensor]) -> torch.Tensor:
    """The layers stacked in host memory, each copied straight into its
    slot (no stacked copy on the device)."""
    out = torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype)
    for slot, t in zip(out, ts):
        slot.copy_(t.detach())
    return out


def train_state_to_reference(state: Dict[str, Any], cfg: ModelConfig
                             ) -> Dict[str, Any]:
    """Port train state ``{"params", "opt": {"mu", "nu", "step"[,
    "master"]}}`` -> the same in the reference's layout, the tree that a
    checkpoint of either package holds; ``step`` stays an int. Every leaf
    is a host copy that shares nothing with ``state`` (the layers of a
    stacked leaf copied straight into their slots, so the device holds no
    stacked copy), as ``AsyncCheckpointer.save``'s ``to_host`` must give
    them."""
    stacked = lambda tree: _restack(  # noqa: E731
        tree, cfg, lambda t: t.detach().to("cpu", copy=True), _host_stack)
    opt = state["opt"]
    out_opt = {k: stacked(opt[k]) for k in _OPT_TREES if k in opt}
    out_opt["step"] = opt["step"]
    return {"params": stacked(state["params"]), "opt": out_opt}


def _copy_leaf(pair) -> torch.Tensor:
    dst, src = pair
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"restored leaf is {src.dtype} {tuple(src.shape)}, "
                         f"the state's {dst.dtype} {tuple(dst.shape)}")
    return dst.copy_(src)


def train_state_from_reference(tree: Dict[str, Any], cfg: ModelConfig, *,
                               device="cuda", into=None) -> Dict[str, Any]:
    """The inverse of :func:`train_state_to_reference`: leaves (tensors or
    NumPy arrays) are moved to ``device``, ``step`` becomes an int. With
    ``into`` (a port train state of the same shapes and dtypes) the values
    are copied into its tensors instead, whose values are never read, and
    ``device`` is not used: a restore then holds no second copy of the
    state on the device."""
    dev = resolve_device(device) if into is None else None

    def to_t(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        return t if dev is None else t.to(dev)

    opt = tree["opt"]
    out_opt = {k: _unstack(opt[k], cfg, to_t) for k in _OPT_TREES if k in opt}
    params = _unstack(tree["params"], cfg, to_t)
    if into is not None:
        keys = [k for k in _OPT_TREES if k in into["opt"]]
        if sorted(keys) != sorted(out_opt):
            raise ValueError(f"restored optimizer state holds {sorted(out_opt)}"
                             f", the state's {sorted(keys)}")
        params = _zip_map(_copy_leaf, [into["params"], params])
        out_opt = {k: _zip_map(_copy_leaf, [into["opt"][k], out_opt[k]])
                   for k in keys}
    out_opt["step"] = int(opt["step"])
    return {"params": params, "opt": out_opt}


def _ring(k, v, slot_pos, pos: int, to_t) -> KVCache:
    """A reference ring -> the port's. The port's ring keeps no slot_pos:
    slot s must hold the largest position p < pos with p = s (mod C), or
    -1 if there is none."""
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
    return KVCache(k=to_t(k), v=to_t(v))


def decode_state_from_reference(state, cfg: ModelConfig, *,
                                device="cuda"):
    """Reference ``DecodeState`` (NumPy leaves: ``blocks`` a tuple of
    per-pattern-position states stacked over the blocks, ``tail`` a list of
    per-layer states, ``pos`` a scalar) -> the port's, one state per layer
    in schedule order: a ``KVCache`` for an attention layer, a
    ``MambaState`` or ``RGLRUState`` (``h``, ``conv``) for a Mamba or
    RG-LRU layer. For an encoder-decoder config, a reference
    ``EncDecState`` (``self_caches`` a ``KVCache`` stacked over the decoder
    layers, ``cross_kv`` a stacked (k, v) pair) -> the port's
    ``EncDecState``, a ring and a (k, v) pair a layer. Read by attribute,
    so the reference's NamedTuples pass as they are. A ring (wrapped or
    not) converts when its ``slot_pos`` is what writing position ``p`` at
    slot ``p % C`` leaves; any other layout raises."""
    dev = resolve_device(device)
    to_t = lambda a: torch.tensor(np.asarray(a), device=dev)  # noqa: E731
    pos = int(np.asarray(state.pos))
    if cfg.is_encdec:
        sc = state.self_caches
        k, v, slot_pos = (np.asarray(sc.k), np.asarray(sc.v),
                          np.asarray(sc.slot_pos))
        ck, cv = (np.asarray(a) for a in state.cross_kv)
        if not k.shape[0] == ck.shape[0] == cfg.num_layers:
            raise ValueError(f"state holds {k.shape[0]} rings and "
                             f"{ck.shape[0]} cross (k, v) pairs, config "
                             f"{cfg.name} has {cfg.num_layers} layers")
        return EncDecState(
            self_caches=[_ring(k[i], v[i], slot_pos[i], pos, to_t)
                         for i in range(cfg.num_layers)],
            cross_kv=[(to_t(ck[i]), to_t(cv[i]))
                      for i in range(cfg.num_layers)],
            pos=pos)
    pattern, nb, tail = cfg.scan_split()
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
        layers.append(_ring(take(st.k), take(st.v), take(st.slot_pos), pos,
                            to_t))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"state holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return DecodeState(layers=layers, pos=pos)
