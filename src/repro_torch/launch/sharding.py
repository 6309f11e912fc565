"""Per-architecture sharding rules (DP/TP/EP/ZeRO-1 over the production mesh).

The reference's rules (``repro/launch/sharding.py``), on the port's trees:

  * ``model`` axis: tensor/expert parallelism — vocab, heads, d_ff, experts,
    d_inner, lru_width.
  * ``data`` (+ ``pod``) axes: batch data parallelism; ZeRO-1 additionally
    shards optimizer moments over ``data`` on each param's largest
    still-unsharded divisible dim.
  * dims are sharded over an axis only when divisible (argument shardings
    must divide evenly); kv-head dims smaller than the axis (qwen2-vl kv=2,
    phi3 kv=10, recurrentgemma kv=1) fall back to head_dim.

The rules key on the reference's **stacked** leaf paths: a block-pattern
position's layers stacked over a leading ``num_blocks`` axis
(``['blocks']['l{i}']...``), the remainder layers in ``['tail'][j]``, an
encoder-decoder's layers in ``['enc_blocks']`` / ``['dec_blocks']``. The
port keeps one dict per layer, so each spec is computed on that stacked
view (the leaf mapping of ``models/convert.py``) and the stack entry is
dropped for each per-layer leaf. ZeRO-1 can put ``data`` on the stack axis
itself (falcon-mamba's per-channel leaves on the 16×16 mesh), which a
per-layer placement cannot express: those per-layer moments stay
replicated over ``data`` (:func:`zero1_stack_axis_leaves` names them), and
per-device bytes are counted from the stacked specs, which is exact
(:func:`reference_specs`, :func:`local_bytes`).

A spec is a :class:`P`: one entry per dim, an axis name, a tuple of axis
names (major to minor) or None. :func:`to_placements` maps one to DTensor
placements over a ``DeviceMesh`` of the same axes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, mesh_axis_sizes

BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec (the reference's ``PartitionSpec``): one entry per
    tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def _batch_size(mesh: Mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in _batch_axes(mesh):
        n *= sizes[a]
    return n


def _maybe(dim: int, axis: str, axis_size: int) -> Optional[str]:
    """Shard ``dim`` over ``axis`` only when divisible."""
    if dim >= axis_size and dim % axis_size == 0:
        return axis
    return None


def param_leaf_spec(path: str, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """The spec of one leaf of the reference's (stacked) param tree, by its
    ``jax.tree_util.keystr`` path."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    stacked = any(
        f"['{k}']" in path for k in ("blocks", "enc_blocks", "dec_blocks")
    )
    nd = len(shape) - (1 if stacked else 0)
    trail = shape[len(shape) - nd:]
    name = path.rsplit("['", 1)[-1].rstrip("']")

    def spec(*axes) -> P:
        if len(axes) != nd:
            raise AssertionError((path, shape, axes))
        return P(*((None,) + axes)) if stacked else P(*axes)

    # embeddings / unembedding
    if name == "table":
        v = _maybe(trail[0], "model", m)
        if v:
            return spec(v, None)
        # odd vocab (whisper 51865): replicate
        return spec(None, None)
    if path.endswith("['lm_head']['w']"):
        return spec(None, _maybe(trail[1], "model", m))
    if name in ("enc_pos", "dec_pos"):
        return spec(None, None)

    # attention — shard heads when divisible, else fall back to head_dim
    if name in ("wq", "wk", "wv") and nd == 3:
        h = _maybe(trail[1], "model", m)
        if h:
            return spec(None, h, None)
        return spec(None, None, _maybe(trail[2], "model", m))
    if name == "wo" and nd == 3:
        h = _maybe(trail[0], "model", m)
        if h:
            return spec(h, None, None)
        return spec(None, _maybe(trail[1], "model", m), None)
    if name in ("bq", "bk", "bv"):
        h = _maybe(trail[0], "model", m)
        if h:
            return spec(h, None)
        return spec(None, _maybe(trail[1], "model", m))

    # MoE experts (3-D) before dense GLU (2-D)
    if name in ("gate", "up", "down") and nd == 3:
        return spec(_maybe(trail[0], "model", m), None, None)
    if name in ("gate", "up", "shared_gate", "shared_up", "fc1") and nd == 2:
        return spec(None, _maybe(trail[1], "model", m))
    if name in ("down", "shared_down", "fc2") and nd == 2:
        return spec(_maybe(trail[0], "model", m), None)
    if name == "fc1_b":
        return spec(_maybe(trail[0], "model", m))
    if name == "router":
        return spec(None, None)

    # mamba
    if name == "in_proj":
        return spec(None, _maybe(trail[1], "model", m))
    if name == "x_proj":
        return spec(_maybe(trail[0], "model", m), None)
    if name == "dt_proj":
        return spec(None, _maybe(trail[1], "model", m))
    if name in ("dt_bias", "D", "conv_b"):
        return spec(_maybe(trail[0], "model", m))
    if name == "A_log":
        return spec(_maybe(trail[0], "model", m), None)
    if name == "conv_w":
        return spec(None, _maybe(trail[1], "model", m))
    if name == "out_proj":
        return spec(_maybe(trail[0], "model", m), None)

    # rg-lru
    if name in ("wx", "wy"):
        return spec(None, _maybe(trail[1], "model", m))
    if name in ("w_r", "w_i"):
        return spec(None, _maybe(trail[1], "model", m))
    if name in ("b_r", "b_i", "lam"):
        return spec(_maybe(trail[0], "model", m))
    if name == "wo" and nd == 2:   # rg-lru out projection (w, d)
        return spec(_maybe(trail[0], "model", m), None)

    # norms, scalars, everything small: replicate
    return spec(*([None] * nd))


def _zero1(shape: Tuple[int, ...], spec: P, mesh: Mesh) -> P:
    """Moment sharding: param spec + 'data' on the largest free divisible
    dim (the reference's ``zero1_specs`` on one leaf)."""
    d = mesh_axis_sizes(mesh).get("data", 1)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (dim, s) in enumerate(zip(shape, parts)):
        if s is None and dim % d == 0 and dim > best_size and dim >= d:
            best, best_size = i, dim
        elif s == "data":
            return P(*parts)
    if best is not None:
        parts[best] = "data"
    return P(*parts)


# -- the stacked view ------------------------------------------------------------
def _walk(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(``keystr`` path, leaf) in ``jax.tree`` flattening order: dict keys
    sorted, sequences by index, NamedTuple fields as attributes."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}[{i}]")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def _layer_refs(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    """For each port layer list and index: (port prefix, reference prefix,
    stack size or 0 for an unstacked layer), in the port's order."""
    if cfg.is_encdec:
        return ([(f"['enc_blocks'][{j}]", "['enc_blocks']", cfg.encoder_layers)
                 for j in range(cfg.encoder_layers)]
                + [(f"['dec_blocks'][{j}]", "['dec_blocks']", cfg.num_layers)
                   for j in range(cfg.num_layers)])
    pattern, nb, _ = cfg.scan_split()
    out = []
    for j in range(cfg.num_layers):
        if j < nb * len(pattern):
            out.append((f"['layers'][{j}]", f"['blocks']['l{j % len(pattern)}']",
                        nb))
        else:
            out.append((f"['layers'][{j}]",
                        f"['tail'][{j - nb * len(pattern)}]", 0))
    return out


class _Leaf:
    """One reference leaf: its stacked shape and dtype and the port leaves
    it holds (one, or one a layer of a block-pattern position)."""

    def __init__(self, shape, dtype, stacked: bool):
        self.shape, self.dtype, self.stacked = tuple(shape), dtype, stacked
        self.port_paths: List[str] = []


def reference_leaves(params, cfg: ModelConfig) -> Dict[str, _Leaf]:
    """The reference's stacked param tree of the port's ``params``: its
    ``keystr`` paths, each with its stacked shape, dtype and the port leaf
    paths it stacks."""
    layer_of = {port: (ref, n) for port, ref, n in _layer_refs(cfg)}
    out: Dict[str, _Leaf] = {}
    for path, t in _walk(params):
        ref, n = path, 0
        for port, (rp, stack) in layer_of.items():
            if path.startswith(port + "["):
                ref, n = rp + path[len(port):], stack
                break
        if ref not in out:
            shape = ((n,) if n else ()) + tuple(t.shape)
            out[ref] = _Leaf(shape, t.dtype, bool(n))
        out[ref].port_paths.append(path)
    return out


def _unstack(params, by_port_path: Dict[str, P]):
    """The port tree of ``params`` with each leaf replaced by its spec."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}['{k}']") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
        return by_port_path[prefix]
    return walk(params, "")


def reference_specs(params, mesh: Mesh, cfg: ModelConfig, *,
                    zero1: bool = False) -> Dict[str, Tuple[_Leaf, P]]:
    """reference path -> (its leaf, its stacked spec): the param specs, or
    with ``zero1`` the moment specs."""
    out = {}
    for ref, leaf in reference_leaves(params, cfg).items():
        spec = param_leaf_spec(ref, leaf.shape, mesh)
        if zero1:
            spec = _zero1(leaf.shape, spec, mesh)
        out[ref] = (leaf, spec)
    return out


def _per_layer(params, mesh, cfg, zero1: bool):
    by_port = {}
    for leaf, spec in reference_specs(params, mesh, cfg, zero1=zero1).values():
        per = P(*spec[1:]) if leaf.stacked else spec
        for p in leaf.port_paths:
            by_port[p] = per
    return _unstack(params, by_port)


def param_specs(abstract_params, mesh: Mesh, cfg: ModelConfig):
    """The port's param tree with a :class:`P` a leaf."""
    return _per_layer(abstract_params, mesh, cfg, zero1=False)


def zero1_specs(abstract_params, mesh: Mesh, cfg: ModelConfig):
    """Moment specs, the port's tree: the stacked ZeRO-1 spec minus the
    stack entry (a stack axis on ``data`` becomes replication over
    ``data``)."""
    return _per_layer(abstract_params, mesh, cfg, zero1=True)


def zero1_stack_axis_leaves(abstract_params, mesh: Mesh, cfg: ModelConfig
                            ) -> List[str]:
    """The reference paths whose ZeRO-1 spec puts ``data`` on the stack
    axis."""
    return [ref for ref, (leaf, spec) in
            reference_specs(abstract_params, mesh, cfg, zero1=True).items()
            if leaf.stacked and spec[0] == "data"]


def opt_state_specs(abstract_params, mesh: Mesh, cfg: ModelConfig,
                    master_weights: bool = False) -> Dict[str, Any]:
    z = zero1_specs(abstract_params, mesh, cfg)
    out = {"mu": z, "nu": z, "step": P()}
    if master_weights:
        out["master"] = z
    return out


def batch_specs(abstract_batch: Dict[str, torch.Tensor], mesh: Mesh
                ) -> Dict[str, P]:
    baxes = _batch_axes(mesh)
    bsize = _batch_size(mesh)

    def one(leaf):
        if leaf.shape and leaf.shape[0] % bsize == 0 and leaf.shape[0] > 0:
            return P(baxes, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return {k: one(v) for k, v in abstract_batch.items()}


def decode_state_specs(abstract_state, mesh: Mesh, cfg=None):
    """KV caches: batch over data axes, kv-heads over model when divisible;
    SSM/LRU states: batch over data, channel dim over model. The state's
    structure with a :class:`P` a tensor leaf; ``pos`` (a host int) is
    kept. The reference stacks the states of a block's layers; its lead
    entry is always None, so a per-layer spec is the reference's minus it."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    baxes = _batch_axes(mesh)
    bsize = _batch_size(mesh)

    def one(leaf: torch.Tensor) -> P:
        tshape = tuple(leaf.shape)
        nd = len(tshape)
        if nd == 0:
            return P()
        parts: List[Any] = [None] * nd
        if tshape[0] % bsize == 0 and tshape[0] >= bsize:
            parts[0] = baxes
        if nd == 4:                      # (B, C, K, hd) kv cache
            kvh = _maybe(tshape[2], "model", m)
            if kvh:
                parts[2] = kvh
            else:                        # MQA-ish: shard head_dim instead
                parts[3] = _maybe(tshape[3], "model", m)
        elif nd == 3:                    # (B, di, n) ssm or (B, cw-1, di) conv
            if tshape[1] % m == 0 and tshape[1] >= 2 * m:
                parts[1] = "model"
            elif tshape[2] % m == 0 and tshape[2] >= 2 * m:
                parts[2] = "model"
        elif nd == 2 and tshape[1] % m == 0 and tshape[1] >= 2 * m:
            parts[1] = "model"           # (B, w) lru state
        return P(*parts)

    return tree_map(one, abstract_state)


def logits_spec(mesh: Mesh, batch_size: int = 0, vocab: int = 0) -> P:
    b = _batch_axes(mesh)
    if len(b) == 1:
        b = b[0]                       # canonical bare-axis form ("data",) -> "data"
    if batch_size and batch_size % _batch_size(mesh) != 0:
        b = None                       # e.g. long_500k batch=1
    m = mesh_axis_sizes(mesh).get("model", 1)
    v = "model" if (not vocab or vocab % m == 0) else None  # whisper vocab 51865
    return P(b, None, v)


# -- trees, bytes, placements ------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor (or :class:`P`) leaves of ``tree`` and the
    same leaves of ``rest``; dicts, lists, tuples and NamedTuples keep
    their structure, anything else (a host int) is kept as it is."""
    if isinstance(tree, (torch.Tensor, P)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return tree


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_bytes(shape, dtype: torch.dtype, spec: P, mesh: Mesh) -> int:
    """Bytes of one device's shard of a ``shape`` tensor under ``spec``
    (every sharded dim divides evenly, as the rules ensure; an axis the
    mesh lacks, as ``model`` on the host mesh, has size 1)."""
    sizes = mesh_axis_sizes(mesh)
    n = torch.empty((), dtype=dtype).element_size()
    for i, dim in enumerate(shape):
        k = 1
        for a in _axes(spec[i] if i < len(spec) else None):
            k *= sizes.get(a, 1)
        if dim % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {spec}")
        n *= dim // k
    return n


def tree_local_bytes(tree, specs, mesh: Mesh) -> int:
    total = []
    tree_map(lambda t, s: total.append(local_bytes(t.shape, t.dtype, s, mesh)),
             tree, specs)
    return sum(total)


def to_placements(spec: P, mesh: Mesh) -> list:
    """DTensor placements, one a mesh axis in ``mesh.axis_names`` order:
    ``Shard(i)`` for the axis on dim i, else ``Replicate()``. An axis tuple
    shards its dim over the axes major to minor, as the mesh orders them.
    An axis of size 1 replicates (the same layout, and DTensor cannot
    reshape away a dim sharded over one device)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axis_sizes(mesh)
    where = {}
    for i, entry in enumerate(spec):
        for a in _axes(entry):
            if sizes.get(a, 1) > 1:
                where[a] = i
    return [Shard(where[a]) if a in where else Replicate()
            for a in mesh.axis_names]
