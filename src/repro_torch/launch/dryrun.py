"""Dry run: every (arch × shape) cell on the production meshes, on the meta
device — FLOPs, bytes, per-device collective bytes and memory — for the
roofline at H100 constants (``launch/roofline.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k --mesh multipod
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun.jsonl

Nothing is allocated and nothing is compiled: the step runs on meta
tensors at full width and full depth, the kernels through their meta ops
(``kernels/meta.py``). :func:`run_cell` makes three passes:

A) global FLOPs and bytes: the unsharded step — ``loss`` + backward +
   ``adamw_update`` for ``train`` with the picked microbatches,
   ``prefill_logits``, or one ``decode`` at a full cache — under
   ``FlopCounterMode`` and a byte counter (:class:`ByteCounter`).
B) per-device collectives, FLOPs, bytes and peak memory: the same step with
   every argument a DTensor placed by the sharding rules
   (``launch/sharding.py``) over a fake process group of the mesh's size
   (``torch.testing._internal.distributed.fake_pg``), in one process, as
   rank 0 sees it (:class:`DeviceCounter`). Collectives are DTensor's
   functional collectives, in place of the reference's GSPMD ones, at full
   depth (every cell fits in the CPU time the reference's nb = 2, 4
   extrapolation was there to save).
C) per-device memory of the arguments and outputs, from the specs (exact:
   every sharded dim divides evenly).

The record has the reference's keys, so that ``roofline.analyze_record``
is one function in both packages. In the port they hold:

  arch, shape, kind, mesh, chips, tag   the cell (``mesh`` "16x16",
                          "2x16x16", or the host mesh's "1")
  hlo_flops               pass A: ``FlopCounterMode`` total (matmuls,
                          convolutions, the meta ops' formulas), global
  hlo_bytes               pass A: operand + result bytes of every op that is
                          not a view, global — pre-fusion traffic, as XLA's
                          "bytes accessed" of the unfused program
  collectives             pass B: result bytes a device of each kind
                          (all-reduce, all-gather, reduce-scatter,
                          all-to-all, collective-permute) and ``count``
  collectives_method      "exact(dtensor)", or "exact(dtensor,pod*data)" on
                          the multi-pod mesh (``pod`` folded into ``data``:
                          :func:`_fold`)
  device_flops, device_bytes   pass B: one device's FLOPs and bytes, of
                          the ops as DTensor runs them (it decomposes an op
                          that has no sharding rule, e.g. softplus's
                          gradient, into several)
  argument_size_in_bytes  pass C: one device's params, optimizer state,
                          batch and decode state
  output_size_in_bytes    pass C: one device's results (train: params and
                          optimizer state, updated in place; prefill:
                          logits; decode: logits and the state)
  temp_size_in_bytes      pass B: the peak of live bytes of storages created
                          during the step on one device (arguments excluded)
  t_lower_s               building the abstract trees and specs
  t_lower_unrolled_s      pass A's wall time
  t_compile_s             pass B's wall time
  scanned_collectives     None: there is no scanned program
  params_total, params_active, model_flops, tokens_per_step   as the
                          reference computes them

There is no ``generated_code_size_in_bytes``: no code is compiled.

The fake process group is process-global: :func:`fake_process_group`
creates it only inside :func:`run_cell`, refuses to run where a process
group already exists, and destroys it on the way out, returned or raised.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import json
import os
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import (
    FlopCounterMode,
    conv_flop_count,
    flop_registry,
    shape_wrapper,
)

from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, ShapeConfig
from repro_torch.configs.registry import cells, get_config
from repro_torch.kernels import meta  # noqa: F401  (registers the meta ops' formulas)
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (
    Mesh,
    device_mesh,
    make_production_mesh,
    mesh_axis_sizes,
)
from repro_torch.models import build_model
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import OptConfig, init_opt_state, leaves
from repro_torch.train.train_step import make_train_step

aten = torch.ops.aten

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# DTensor's functional collectives -> the reference's kinds
_FUNCOL_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
# ops that move no data
_NO_BYTES = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten.detach.default,
             aten.alias.default, aten.lift_fresh.default,
             aten._unsafe_view.default}


# -- FLOPs -----------------------------------------------------------------------
def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kw) -> int:
    """Each requested gradient of a convolution costs its forward's FLOPs
    (torch's own formula ignores groups, and counts a depthwise conv's
    weight gradient as a dense one)."""
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


_FLOP_MAPPING = {aten.convolution_backward: _conv_backward_flops}


def flop_counter() -> FlopCounterMode:
    """``FlopCounterMode`` with the dry run's formulas: torch's, the meta
    ops' (``kernels/meta.py``) and a group-aware convolution backward. A
    card run that holds its count to the dry run's uses this one too."""
    return FlopCounterMode(display=False, custom_mapping=_FLOP_MAPPING)


_FLOPS = {**flop_registry,
          **{k: shape_wrapper(v) for k, v in _FLOP_MAPPING.items()}}


def _op_flops(func, args, kwargs, out) -> int:
    f = _FLOPS.get(func._overloadpacket)
    return int(f(*args, **kwargs, out_val=out)) if f is not None else 0


# -- bytes -----------------------------------------------------------------------
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_bytes(func, args, kwargs, out) -> int:
    """Operand + result bytes of one op; 0 for a view or an op that moves
    no data."""
    if func in _NO_BYTES or getattr(func, "is_view", False):
        return 0
    return (sum(_nbytes(t) for t in _tensors((args, kwargs)))
            + sum(_nbytes(t) for t in _tensors(out)))


class ByteCounter(TorchDispatchMode):
    """Sums :func:`_op_bytes` over every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.bytes += _op_bytes(func, args, kwargs, out)
        return out


class DeviceCounter(TorchDispatchMode):
    """Pass B's counter, on one device's local tensors: DTensor ops are let
    through (``NotImplemented``) so that their local ops and collectives
    come back here. Counts collective result bytes by kind, FLOPs and
    bytes of every local op, and the peak of live bytes of storages
    created under it (a storage's bytes leave when it is freed)."""

    def __init__(self, arguments):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self._fake = FakeTensor
        self.in_alltoall = 0
        self.collectives: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
        self.collectives["count"] = 0
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = set()
        self._args = {self._key(t) for t in _tensors(arguments)}

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def counts(self) -> Dict[str, float]:
        return {**self.collectives, "device_flops": float(self.flops),
                "device_bytes": float(self.bytes)}

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(issubclass(t, self._fake) for t in types)
                or any(isinstance(t, self._fake) for t in _tensors(out))):
            return out           # DTensor's sharding propagation, no device op
        ns = func.namespace
        if self.in_alltoall:
            pass                 # counted whole by :func:`_alltoall_counted`
        elif ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            name = func._overloadpacket.__name__
            if name not in _NOT_COLLECTIVES:
                kind = _FUNCOL_KINDS.get(name)
                if kind is None:
                    raise ValueError(f"dry run: uncounted collective {func}")
                self.collectives[kind] += sum(_nbytes(t) for t in _tensors(out))
                self.collectives["count"] += 1
        self.flops += _op_flops(func, args, kwargs, out)
        self.bytes += _op_bytes(func, args, kwargs, out)
        self._track(out)
        return out


@contextlib.contextmanager
def _alltoall_counted(counter: DeviceCounter):
    """On a mesh of device type "cpu" DTensor turns a shard-to-shard
    redistribution (an all-to-all) into an all-gather and a local chunk.
    Count each such call as the all-to-all it stands for: its result
    bytes, under ``all-to-all``, and none of the stand-in all-gather."""
    from torch.distributed.tensor import placement_types as pt

    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        raise RuntimeError("torch.distributed.tensor.placement_types has no "
                           "shard_dim_alltoall: the dry run cannot count "
                           "all-to-all redistributions with this torch")

    def counted(*args, **kwargs):
        counter.in_alltoall += 1
        try:
            out = orig(*args, **kwargs)
        finally:
            counter.in_alltoall -= 1
        counter.collectives["all-to-all"] += _nbytes(out)
        counter.collectives["count"] += 1
        return out

    pt.shard_dim_alltoall = counted
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


# -- the fake process group ----------------------------------------------------------
def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:      # a private module: say what is missing
        raise RuntimeError(
            "the dry run's DTensor pass needs "
            "torch.testing._internal.distributed.fake_pg (FakeStore and the "
            "'fake' process-group backend), which this torch does not "
            "have") from e
    return FakeStore


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the duration of the block; refused where a group exists."""
    import torch.distributed as dist

    store = _fake_store()
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    if dist.is_initialized():
        raise RuntimeError("a process group already exists: the dry run "
                           "creates its own fake group and will not run "
                           "beside another")
    dist.init_process_group("fake", store=store(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- the cell ----------------------------------------------------------------------
def pick_num_microbatches(shape: ShapeConfig, mesh: Mesh,
                          requested: Optional[int]) -> int:
    if shape.kind != "train":
        return 1
    if requested:
        return requested
    sizes = mesh_axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    return max(1, min(16, shape.global_batch // dp))


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_cell(arch: str, shape: ShapeConfig, mesh: Mesh, *,
               remat: Optional[str] = None, param_dtype: Optional[str] = None,
               master_weights: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """The config (``arch``'s, or ``cfg``), model, abstract arguments of
    the step and their specs."""
    cfg = cfg or get_config(arch)
    if remat:
        cfg = cfg.replace(remat_policy=remat)
    if param_dtype:
        cfg = cfg.replace(param_dtype=param_dtype)
    if overrides:
        cfg = cfg.replace(**overrides)
    model = build_model(cfg)
    params = model.abstract_params()
    c: Dict[str, Any] = {
        "cfg": cfg, "model": model, "shape": shape, "mesh": mesh,
        "params": params, "p_specs": shd.param_specs(params, mesh, cfg),
        "batch": model.input_specs(shape), "opt": None, "state": None,
    }
    c["b_specs"] = shd.batch_specs(c["batch"], mesh)
    if shape.kind == "train":
        c["opt"] = init_opt_state(params, master_weights=master_weights)
        c["o_specs"] = shd.opt_state_specs(params, mesh, cfg,
                                           master_weights=master_weights)
    elif shape.kind == "decode":
        c["state"] = model.decode_state_specs(shape)
        c["s_specs"] = shd.decode_state_specs(c["state"], mesh, cfg)
    return c


def _microbatches(batch: Dict[str, torch.Tensor], nmb: int) -> list:
    """The microbatches a counted train step runs: ``min(nmb, 2)`` of
    ``B / nmb`` rows each (meta). Microbatches 3..nmb dispatch the same
    ops on the same shapes as the second, so :func:`_extrapolate` counts
    them from it; the second holds the accumulators of the first, so its
    peak memory is every later one's."""
    for k, v in batch.items():
        if v.shape[0] % nmb:
            raise ValueError(f"batch {k} of {v.shape[0]} rows is not a "
                             f"multiple of {nmb} microbatches")
    return [{k: torch.empty((v.shape[0] // nmb, *v.shape[1:]), dtype=v.dtype,
                            device="meta") for k, v in batch.items()}
            for _ in range(min(nmb, 2))]


def _extrapolate(snaps, final: Dict[str, float], nmb: int) -> Dict[str, float]:
    """Counts of an ``nmb``-microbatch step from a run of two: the run's
    total plus (nmb - 2) times the second microbatch's share (``snaps``:
    the counts before the first, before the second and after the second).
    A one-microbatch run is its total."""
    if len(snaps) < 3 or nmb <= 2:
        return dict(final)
    return {k: v + (nmb - 2) * (snaps[2][k] - snaps[1][k])
            for k, v in final.items()}


def _run_step(c: Dict[str, Any], params, opt, batch, state, *,
              accum_dtype, compression, snap=lambda: None):
    """One step of the cell on the given arguments (``batch``: for train,
    the list of microbatches); ``snap()`` is called at each microbatch
    boundary."""
    model, shape = c["model"], c["shape"]
    if shape.kind == "train":
        def split(_batch, _nmb):
            for mb in batch:
                snap()
                yield mb
            snap()

        step = make_train_step(model, OptConfig(), num_microbatches=len(batch),
                               accum_dtype=accum_dtype,
                               compression=compression, split=split)
        if compression == "int8_ef":
            return step(params, opt, batch,
                        grad_compress.init_ef_state(leaves(params)))
        return step(params, opt, batch)
    with torch.no_grad():
        if shape.kind == "prefill":
            return model.prefill_logits(params, batch)
        return model.decode(params, state, batch)


def count_global(c: Dict[str, Any], *, nmb: int, accum_dtype=torch.float32,
                 compression=None) -> Dict[str, Any]:
    """Pass A: FLOPs and bytes of the unsharded step on meta."""
    t0 = time.perf_counter()
    fc, bc = flop_counter(), ByteCounter()
    counts = lambda: {"hlo_flops": float(fc.get_total_flops()),  # noqa: E731
                      "hlo_bytes": float(bc.bytes)}
    snaps = []
    batch = (_microbatches(c["batch"], nmb) if c["shape"].kind == "train"
             else c["batch"])
    with fc, bc:
        _run_step(c, c["params"], c["opt"], batch, c["state"],
                  accum_dtype=accum_dtype, compression=compression,
                  snap=lambda: snaps.append(counts()))
    out = _extrapolate(snaps, counts(), nmb)
    out["t_s"] = time.perf_counter() - t0
    return out


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _fold(mesh: Mesh) -> Mesh:
    """The mesh pass B runs on: the multi-pod mesh with ``pod`` folded into
    ``data`` (2×16×16 -> 32×16). DTensor plans a redistribution that holds a
    strided shard by a search over placement states that grows
    exponentially with the mesh's dims; on three dims one transformer
    layer takes minutes. Batch axes ``("pod", "data")`` become the folded
    ``data``, and so does ZeRO-1's ``data`` (its moments shard 32 ways
    there, not 16; pass C counts the reference's 16)."""
    if "pod" not in mesh.axis_names:
        return mesh
    sizes = mesh_axis_sizes(mesh)
    return Mesh(("data", "model"), (sizes["pod"] * sizes["data"],
                                    sizes.get("model", 1)))


def _fold_spec(spec: shd.P) -> shd.P:
    def one(e):
        axes = shd._axes(e)
        if any(a in ("pod", "data") for a in axes):
            rest = tuple(a for a in axes if a not in ("pod", "data"))
            return ("data",) + rest if rest else "data"
        return e
    return shd.P(*(one(e) for e in spec))


def count_per_device(c: Dict[str, Any], *, nmb: int,
                     accum_dtype=torch.float32, compression=None
                     ) -> Dict[str, Any]:
    """Pass B: the step with DTensor arguments over a fake group of the
    mesh's size; rank 0's collectives, FLOPs, bytes and peak memory."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    mesh, shape = _fold(c["mesh"]), c["shape"]
    meta.register_dtensor_rules()
    t0 = time.perf_counter()
    with fake_process_group(mesh.size):
        dm = device_mesh(mesh)

        def place(t, spec):
            return distribute_tensor(_meta_like(t), dm,
                                     shd.to_placements(_fold_spec(spec), mesh))

        params = shd.tree_map(place, c["params"], c["p_specs"])
        opt = state = None
        if c["opt"] is not None:
            o = c["opt"]
            opt = {k: (o[k] if k == "step" else
                       shd.tree_map(place, o[k], c["o_specs"][k]))
                   for k in o}
        if c["state"] is not None:
            state = shd.tree_map(place, c["state"], c["s_specs"])
        if shape.kind == "train":
            # each microbatch sharded over the batch axes, as a device
            # holds its rows of every microbatch
            batch = [shd.tree_map(place, mb, shd.batch_specs(mb, mesh))
                     for mb in _microbatches(c["batch"], nmb)]
        else:
            batch = shd.tree_map(place, c["batch"], c["b_specs"])
        local = [t.to_local() for t in _tensors((params, opt, batch, state))
                 if hasattr(t, "to_local")]
        counter = DeviceCounter(local)
        snaps = []
        with implicit_replication(), _alltoall_counted(counter), counter:
            _run_step(c, params, opt, batch, state, accum_dtype=accum_dtype,
                      compression=compression,
                      snap=lambda: snaps.append(counter.counts()))
        del params, opt, state, batch, local
    out = _extrapolate(snaps, counter.counts(), nmb)
    return {"collectives": {k: int(out[k]) for k in (*_COLLECTIVES, "count")},
            "device_flops": out["device_flops"],
            "device_bytes": out["device_bytes"],
            "temp_size_in_bytes": int(counter.peak),
            "t_s": time.perf_counter() - t0}


def memory_of_arguments(c: Dict[str, Any]) -> Dict[str, int]:
    """Pass C: one device's argument and output bytes, from the specs (the
    params and moments from the reference's stacked specs, so that ZeRO-1
    on the stack axis is counted as the reference shards it)."""
    cfg, mesh, shape = c["cfg"], c["mesh"], c["shape"]
    params = c["params"]

    def stacked(zero1: bool) -> int:
        return sum(shd.local_bytes(leaf.shape, leaf.dtype, spec, mesh)
                   for leaf, spec in shd.reference_specs(
                       params, mesh, cfg, zero1=zero1).values())

    p_bytes = stacked(False)
    arg = p_bytes + shd.tree_local_bytes(c["batch"], c["b_specs"], mesh)
    if shape.kind == "train":
        m_bytes = sum(shd.local_bytes(leaf.shape, torch.float32, spec, mesh)
                      for leaf, spec in shd.reference_specs(
                          params, mesh, cfg, zero1=True).values())
        n_moments = len([k for k in c["opt"] if k != "step"])
        opt_bytes = n_moments * m_bytes
        return {"argument_size_in_bytes": arg + opt_bytes,
                "output_size_in_bytes": p_bytes + opt_bytes}
    logits = shd.local_bytes(
        (shape.global_batch, 1, cfg.vocab_size), _DT[cfg.dtype],
        shd.logits_spec(mesh, shape.global_batch, cfg.vocab_size), mesh)
    if shape.kind == "prefill":
        return {"argument_size_in_bytes": arg, "output_size_in_bytes": logits}
    st = shd.tree_local_bytes(c["state"], c["s_specs"], mesh)
    return {"argument_size_in_bytes": arg + st,
            "output_size_in_bytes": logits + st}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    *,
    mesh: Optional[Mesh] = None,
    compile_: bool = True,
    analyze: bool = True,
    num_microbatches: Optional[int] = None,
    remat: Optional[str] = None,
    accum_dtype: str = "float32",
    compression: Optional[str] = None,
    param_dtype: Optional[str] = None,
    master_weights: bool = False,
    overrides: Optional[Dict[str, Any]] = None,
    extra_tag: str = "",
    cfg: Optional[ModelConfig] = None,
) -> Dict[str, Any]:
    """One cell's record (module docstring). ``mesh`` replaces the
    production mesh (e.g. ``mesh.make_host_mesh()``), ``cfg`` the arch's
    config (e.g. its ``smoke_config``); ``analyze=False`` skips pass A,
    ``compile_=False`` pass B."""
    _fake_store()
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES_BY_NAME[shape_name])
    shape_name = shape.name
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    c = build_cell(arch, shape, mesh, remat=remat, param_dtype=param_dtype,
                   master_weights=master_weights, overrides=overrides, cfg=cfg)
    cfg = c["cfg"]
    nmb = pick_num_microbatches(shape, mesh, num_microbatches)
    acc = _DT[accum_dtype]
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": mesh_name(mesh), "chips": mesh.size, "tag": extra_tag,
    }
    rec.update(memory_of_arguments(c))
    rec["t_lower_s"] = round(time.perf_counter() - t0, 2)
    rec["scanned_collectives"] = None
    if analyze:
        a = count_global(c, nmb=nmb, accum_dtype=acc, compression=compression)
        rec["hlo_flops"], rec["hlo_bytes"] = a["hlo_flops"], a["hlo_bytes"]
        rec["t_lower_unrolled_s"] = round(a["t_s"], 2)
    if compile_:
        b = count_per_device(c, nmb=nmb, accum_dtype=acc,
                             compression=compression)
        rec["collectives"] = b["collectives"]
        rec["collectives_method"] = ("exact(dtensor)" if _fold(mesh) is mesh
                                     else "exact(dtensor,pod*data)")
        for key in ("device_bytes", "device_flops", "temp_size_in_bytes"):
            rec[key] = b[key]
        rec["t_compile_s"] = round(b["t_s"], 2)

    pc = cfg.param_counts()
    rec["params_total"] = pc["total"]
    rec["params_active"] = pc["active"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    rec["model_flops"] = factor * pc["active"] * tokens
    rec["tokens_per_step"] = tokens
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip pass B (DTensor collectives, temp memory)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--master-weights", action="store_true")
    ap.add_argument("--compression", default=None)
    ap.add_argument("--no-analyze", action="store_true",
                    help="skip pass A (global FLOPs and bytes)")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. num_heads_phys=48")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="build/dryrun.jsonl")
    args = ap.parse_args(argv)

    if args.all:
        todo = list(cells())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, SHAPES_BY_NAME[args.shape])]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for arch, shape in todo:
        for mp in meshes:
            print(f"=== {arch} × {shape.name} × {'2x16x16' if mp else '16x16'} ===",
                  flush=True)
            try:
                rec = run_cell(
                    arch, shape.name, mp,
                    compile_=not args.no_compile,
                    analyze=not args.no_analyze,
                    num_microbatches=args.microbatches,
                    remat=args.remat,
                    accum_dtype=args.accum_dtype,
                    param_dtype=args.param_dtype,
                    master_weights=args.master_weights,
                    compression=args.compression,
                    overrides=overrides,
                    extra_tag=args.tag,
                )
            except Exception as e:
                rec = {
                    "arch": arch, "shape": shape.name,
                    "mesh": "2x16x16" if mp else "16x16",
                    "error": repr(e)[:500], "tag": args.tag,
                }
                print(f"  FAILED: {rec['error']}", flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if "error" not in rec:
                coll = rec.get("collectives") or {}
                csum = sum(v for k, v in coll.items() if k != "count")
                print(
                    f"  ok: A {rec.get('t_lower_unrolled_s', '-')}s B "
                    f"{rec.get('t_compile_s', '-')}s "
                    f"flops={rec.get('hlo_flops') or -1:.3e} coll={csum:.3e}B",
                    flush=True,
                )


if __name__ == "__main__":
    main()
