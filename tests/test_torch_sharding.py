"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``) over ``jax.sharding.AbstractMesh``,
for every arch on both production meshes, leaf for leaf through the
reference's stacked view; and physical head padding.

The rules key on the reference's stacked leaves (a block-pattern
position's layers over a leading ``num_blocks`` axis); the port computes
each spec on that view and drops the stack entry for a per-layer leaf. So
the stacked specs must be equal, and every per-layer spec must be its
stacked spec minus the stack entry — the only permitted difference. Where
ZeRO-1 puts ``data`` on the stack axis (falcon-mamba's per-channel leaves),
the per-layer moment is replicated over ``data``; the test names those
leaves and holds the port's per-device bytes, counted from the stacked
spec, to the reference's ``NamedSharding.shard_shape``.

Head padding: at ``smoke_config`` with ``num_heads_phys`` and
``num_kv_heads_phys`` twice the real counts, the padded model's logits
equal the unpadded model's bit for bit in fp32 (prefill and a decode
step), and match the reference's padded model, its params carried across
by ``models/convert.py``, within tests/test_torch_model.py's fp32
tolerance (1e-5).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    get_config, list_archs, smoke_config)
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402

ARCHS = list_archs()
MESHES = {"16x16": False, "2x16x16": True}

# ZeRO-1 on the stack axis: every (arch, mesh) where the reference's moment
# spec puts ``data`` on a stacked leaf's lead axis. falcon-mamba's 64
# blocks are the only stack the 16-way ``data`` axis divides and that is
# the largest free dim of a leaf whose other dims ``model`` takes or that
# are smaller.
STACK_AXIS = {
    ("falcon-mamba-7b", "16x16"): ["['blocks']['l0']['mixer']['A_log']",
                                   "['blocks']['l0']['mixer']['D']",
                                   "['blocks']['l0']['mixer']['conv_b']",
                                   "['blocks']['l0']['mixer']['conv_w']",
                                   "['blocks']['l0']['mixer']['dt_bias']"],
    ("falcon-mamba-7b", "2x16x16"): ["['blocks']['l0']['mixer']['A_log']",
                                     "['blocks']['l0']['mixer']['D']",
                                     "['blocks']['l0']['mixer']['conv_b']",
                                     "['blocks']['l0']['mixer']['conv_w']",
                                     "['blocks']['l0']['mixer']['dt_bias']"],
}


def _jmesh(multi_pod: bool) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _ref(arch: str):
    return jbuild(jget_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return _ref(arch).abstract_params()


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return build_model(get_config(arch)).abstract_params()


def _flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): v for p, v in leaves}


def _norm(spec) -> tuple:
    """JAX's ``PartitionSpec`` writes a one-axis tuple as the bare axis
    (``("data",)`` is ``"data"``): the same spec."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same(port: shd.P, ref: JP) -> bool:
    return _norm(port) == _norm(ref)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_reference_leaf_for_leaf(arch, mesh_name):
    multi = MESHES[mesh_name]
    jmesh, mesh = _jmesh(multi), make_production_mesh(multi_pod=multi)
    cfg = get_config(arch)
    jp = _ref_params(arch)
    jspec = jshd.param_specs(jp, jmesh)
    jz = _flat(jshd.zero1_specs(jp, jspec, jmesh))
    jspec, jshape = _flat(jspec), {k: v for k, v in (
        (jax.tree_util.keystr(p), s) for p, s in
        jax.tree_util.tree_flatten_with_path(jp)[0])}
    params = _port_params(arch)
    ours = shd.reference_specs(params, mesh, cfg)
    ours_z = shd.reference_specs(params, mesh, cfg, zero1=True)
    assert sorted(ours) == sorted(jspec)
    for path, (leaf, spec) in ours.items():
        assert leaf.shape == tuple(jshape[path].shape), path
        assert _same(spec, jspec[path]), (path, spec, jspec[path])
        assert _same(ours_z[path][1], jz[path]), (path, ours_z[path][1],
                                                  jz[path])
    # per-layer specs: the stacked spec minus the stack entry, nothing else
    per_p = dict(_walk_specs(shd.param_specs(params, mesh, cfg)))
    per_z = dict(_walk_specs(shd.zero1_specs(params, mesh, cfg)))
    for path, (leaf, spec) in ours.items():
        z = ours_z[path][1]
        for pp in leaf.port_paths:
            want = tuple(spec[1:]) if leaf.stacked else tuple(spec)
            assert tuple(per_p[pp]) == want, (pp, per_p[pp], want)
            want_z = (tuple(z[1:]) if leaf.stacked else tuple(z))
            assert tuple(per_z[pp]) == want_z, (pp, per_z[pp], want_z)
    # ZeRO-1 on the stack axis: named, and bytes a device equal
    stack = shd.zero1_stack_axis_leaves(params, mesh, cfg)
    assert sorted(stack) == STACK_AXIS.get((arch, mesh_name), [])
    for path in stack:
        leaf, z = ours_z[path]
        ref_shard = NamedSharding(jmesh, jz[path]).shard_shape(leaf.shape)
        assert shd.local_bytes(leaf.shape, torch.float32, z, mesh) == \
            4 * int(np.prod(ref_shard)), path


def _walk_specs(tree, prefix=""):
    if isinstance(tree, shd.P):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_specs(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk_specs(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_specs(v, f"{prefix}[{i}]")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_logits_specs_match_reference(arch, mesh_name):
    multi = MESHES[mesh_name]
    jmesh, mesh = _jmesh(multi), make_production_mesh(multi_pod=multi)
    cfg = get_config(arch)
    jm, m = _ref(arch), build_model(cfg)
    for jshape, shape in zip(JSHAPES, SHAPES):
        assert jshape.name == shape.name
        jb = jshd.batch_specs(jm.input_specs(jshape), jmesh)
        ob = shd.batch_specs(m.input_specs(shape), mesh)
        assert sorted(ob) == sorted(jb)
        for k in ob:
            assert _same(ob[k], jb[k]), (shape.name, k, ob[k], jb[k])
        assert _same(shd.logits_spec(mesh, shape.global_batch, cfg.vocab_size),
                     jshd.logits_spec(jmesh, jshape.global_batch,
                                      cfg.vocab_size))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_reference(arch, mesh_name):
    """Every port state leaf against its reference leaf (a stacked one minus
    its lead entry). The reference's ring ``slot_pos`` and scalar ``pos``
    have no port tensor (the port's ring reads positions from ``pos``, a
    host int)."""
    multi = MESHES[mesh_name]
    jmesh, mesh = _jmesh(multi), make_production_mesh(multi_pod=multi)
    cfg = get_config(arch)
    jshape = [s for s in JSHAPES if s.name == "decode_32k"][0]
    shape = [s for s in SHAPES if s.name == "decode_32k"][0]
    jst = _ref(arch).decode_state_specs(jshape)
    jspec = _flat(jshd.decode_state_specs(jst, jmesh, jget_config(arch)))
    st = build_model(cfg).decode_state_specs(shape)
    ours = dict(_walk_specs(shd.decode_state_specs(st, mesh, cfg)))
    want = {}
    if cfg.is_encdec:
        for i in range(cfg.num_layers):
            for f in ("k", "v"):
                want[f".self_caches[{i}].{f}"] = jspec[f".self_caches.{f}"][1:]
            for j in (0, 1):
                want[f".cross_kv[{i}][{j}]"] = jspec[f".cross_kv[{j}]"][1:]
    else:
        pattern, nb, tail = cfg.scan_split()
        for li, spec in enumerate(cfg.layer_schedule()):
            fields = ("h", "conv") if spec.mixer in ("mamba", "rglru") \
                else ("k", "v")
            for f in fields:
                if li < nb * len(pattern):
                    ref = jspec[f".blocks[{li % len(pattern)}].{f}"][1:]
                else:
                    ref = jspec[f".tail[{li - nb * len(pattern)}].{f}"]
                want[f".layers[{li}].{f}"] = ref
    assert sorted(ours) == sorted(want)
    for k in ours:
        assert _norm(ours[k]) == _norm(want[k]), (k, ours[k], want[k])


# -- physical head padding ---------------------------------------------------------
PAD_ARCHS = [a for a in ARCHS
             if not get_config(a).is_encdec and not get_config(a).attention_free]


def _padded(cfg):
    return cfg.replace(num_heads_phys=2 * cfg.num_heads,
                       num_kv_heads_phys=2 * cfg.num_kv_heads)


def _embed(cfg, rng, B, S):
    if cfg.input_mode == "embeddings":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", PAD_ARCHS)
def test_padded_heads_match_unpadded_bitwise_and_reference(arch):
    jcfg = jsmoke(jget_config(arch)).replace(dtype="float32")
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    jpcfg, pcfg = _padded(jcfg), _padded(cfg)
    # the reference's padded params, carried into the port; the real model
    # takes their real slices
    jparams = jax.tree.map(np.asarray,
                           jbuild(jpcfg).init(jax.random.PRNGKey(0)))
    padded = from_reference(jparams, pcfg, device="cpu")
    H, K = cfg.num_heads, cfg.num_kv_heads

    def real(t, path=""):
        if isinstance(t, dict):
            return {k: real(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [real(v, path) for v in t]
        if path in ("wq", "bq"):
            return t[:, :H].clone() if path == "wq" else t[:H].clone()
        if path in ("wk", "wv"):
            return t[:, :K].clone()
        if path in ("bk", "bv"):
            return t[:K].clone()
        if path == "wo" and t.dim() == 3:
            return t[:H].clone()
        return t.clone()

    unpadded = real(padded)
    rng = np.random.default_rng(0)
    batch = _embed(cfg, rng, 2, 24)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    m, pm = build_model(cfg), build_model(pcfg)
    with torch.no_grad():
        a = m.prefill_logits(unpadded, tb)
        b = pm.prefill_logits(padded, tb)
    assert torch.equal(a, b)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jbuild(jpcfg).prefill_logits(jparams, jb))
    np.testing.assert_allclose(b.numpy(), ref, rtol=1e-5, atol=1e-5)
    # one decode step each from an empty cache: the padded cache holds the
    # physical kv heads, the kernel's G is the real one
    step = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32))}
    if cfg.input_mode == "embeddings":
        step = {"embeds": torch.from_numpy(
            rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32))}
    with torch.no_grad():
        st, pst = m.init_decode_state(unpadded, 2, 8), pm.init_decode_state(
            padded, 2, 8)
        assert {c.k.shape[2] for c in pst.layers if hasattr(c, "k")} == {2 * K}
        la, _ = m.decode(unpadded, st, step)
        lb, _ = pm.decode(padded, pst, step)
    assert torch.equal(la, lb)
