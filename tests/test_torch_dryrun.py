"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) at small size, against what the reference
can still compute on the CPU.

The reference's own dry run fails under this JAX (its embedding gather
raises ``ShardingTypeError`` on the production mesh), so the port is held
piece by piece:

* FLOPs: pass A (``count_global``) at ``smoke_config`` (B = 2, S = 64) in
  prefill, decode and train equals 2·M·N·K summed over the ``dot_general``
  ops of the reference's ``jax.jit(...).lower(abstract_params,
  input_specs).as_text()`` with ``scan_layers=False`` and no mesh. Train is
  the loss's gradient on both sides (the optimizer has no contraction) with
  the remat policy matched: "none", and "full" (the port's "dots" recomputes
  the whole block, as "full" does). Every family without a recurrent layer
  is exact. falcon-mamba and recurrentgemma differ by exactly their
  depthwise causal convolutions: the port counts ``F.conv1d``'s FLOPs
  (2·B·S·c·cw a conv, as ``FlopCounterMode`` counts a grouped conv; its
  gradient twice that), where the reference's ``conv_general_dilated`` is
  not a ``dot_general``. The test computes that difference from the
  schedule and holds the rest exact; no tolerance.
* Counters: on a two-layer toy (a column-parallel then a row-parallel
  matmul) over a fake process group at mesh (2, 2) and (2, 2, 2), the
  collective counter gives the row-parallel all-reduce of (B, S, d) and the
  data-parallel gradient all-reduce (one a batch axis) worked out by hand,
  and the byte counter an op's operand and result bytes.
* Roofline: ``analyze_record`` on a port record equals the reference's,
  whose constants are set to the H100's.
* Records carry the reference's keys; the fake process group is gone when
  ``run_cell`` returns or raises, and ``run_cell`` refuses to run beside an
  existing group.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs.base import MAMBA, RGLRU, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    get_config, list_archs, smoke_config)
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh, device_mesh  # noqa: E402
from repro_torch.models.layers import shard_act  # noqa: E402

B, S = 2, 64
HOST = Mesh(("data",), (1,))


# -- the reference's dot_general FLOPs ------------------------------------------------
def _dims(t: str):
    m = re.match(r"tensor<((?:\d+x)*)[a-z0-9]+>", t)
    return [int(x) for x in m.group(1).split("x") if x]


def dot_general_flops(text: str) -> int:
    """2·M·N·K over every ``stablehlo.dot_general``: 2 × the result's
    elements × the product of the lhs contracting dims."""
    total = 0
    for line in text.splitlines():
        if "stablehlo.dot_general" not in line:
            continue
        cd = re.search(r"contracting_dims = \[([0-9, ]*)\] x", line)
        sig = re.search(r":\s*\((tensor<[^>]*>),\s*(tensor<[^>]*>)\)\s*->\s*"
                        r"(tensor<[^>]*>)", line)
        lhs, out = _dims(sig.group(1)), _dims(sig.group(3))
        k = int(np.prod([lhs[int(i)] for i in cd.group(1).split(",")
                         if i.strip()]))
        total += 2 * int(np.prod(out)) * k
    return total


def _ref_flops(arch: str, kind: str, remat: str) -> int:
    cfg = jsmoke(jget_config(arch)).replace(scan_layers=False,
                                           remat_policy=remat)
    m = jbuild(cfg)
    shape = JShape("smoke", S, B, kind)
    p, b = m.abstract_params(), m.input_specs(shape)
    if kind == "prefill":
        lo = jax.jit(m.prefill_logits).lower(p, b)
    elif kind == "decode":
        lo = jax.jit(m.decode).lower(p, m.decode_state_specs(shape), b)
    else:
        lo = jax.jit(lambda p, b: jax.grad(lambda q: m.loss(q, b)[0])(p)
                     ).lower(p, b)
    return dot_general_flops(lo.as_text())


def _conv_flops(cfg, kind: str, remat: str) -> int:
    """The port's count of its depthwise causal convs (module docstring)."""
    if kind == "decode":
        return 0                   # both sides: an einsum over the window
    pattern, nb, _ = cfg.scan_split()
    total = 0
    for i, spec in enumerate(cfg.layer_schedule()):
        c = {MAMBA: cfg.d_inner, RGLRU: cfg.lru_width}.get(spec.mixer)
        if c is None:
            continue
        fwd = 2 * B * S * c * cfg.conv_width
        if kind == "prefill":
            total += fwd
        else:
            recompute = remat != "none" and i < nb * len(pattern)
            total += fwd * (1 + int(recompute) + 2)
    return total


CASES = [(a, k, r) for a in list_archs()
         for k, r in (("prefill", "none"), ("decode", "none"),
                      ("train", "none"), ("train", "full"))]


@pytest.mark.parametrize("arch,kind,remat", CASES,
                         ids=[f"{a}-{k}-{r}" for a, k, r in CASES])
def test_pass_a_flops_equal_reference_dot_generals(arch, kind, remat):
    cfg = smoke_config(get_config(arch)).replace(remat_policy=remat)
    c = dryrun.build_cell(arch, ShapeConfig("smoke", S, B, kind), HOST,
                          cfg=cfg)
    ours = dryrun.count_global(c, nmb=1)["hlo_flops"]
    assert ours == _ref_flops(arch, kind, remat) + _conv_flops(cfg, kind,
                                                               remat)


def test_microbatches_counted_from_two_equal_a_full_run():
    """Pass A counts microbatches 3..n as repeats of the second: the same
    FLOPs as running them all (bytes too, as the same ops run)."""
    cfg = smoke_config(get_config("phi4-mini-3.8b"))
    c = dryrun.build_cell("phi4-mini-3.8b", ShapeConfig("s", S, 8, "train"),
                          HOST, cfg=cfg)
    two = dryrun.count_global(c, nmb=4)
    fc, bc = dryrun.flop_counter(), dryrun.ByteCounter()
    mbs = [{k: torch.empty((2, *v.shape[1:]), dtype=v.dtype, device="meta")
            for k, v in c["batch"].items()} for _ in range(4)]
    with fc, bc:
        dryrun._run_step(c, c["params"], c["opt"], mbs, None,
                         accum_dtype=torch.float32, compression=None)
    assert two["hlo_flops"] == fc.get_total_flops()
    assert two["hlo_bytes"] == bc.bytes


# -- counters ------------------------------------------------------------------------
def test_byte_counter_counts_operands_and_results():
    x = torch.empty((8, 16), device="meta")
    w = torch.empty((16, 4), device="meta")
    with dryrun.ByteCounter() as bc:
        y = x @ w                     # 4·(8·16 + 16·4 + 8·4)
        y.t()                         # a view: no bytes
        y + y                         # 4·(3·8·4)
    assert bc.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * 3 * 32


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)])
def test_collective_counter_matches_hand_worked_bytes(shape):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = Mesh(names, shape)
    baxes = tuple(a for a in ("pod", "data") if a in names)
    dp, tp = mesh.size // shape[-1], shape[-1]
    Bt, St, d, f = 8, 4, 16, 32
    with dryrun.fake_process_group(mesh.size):
        dm = device_mesh(mesh)

        def place(shape_, *spec):
            return distribute_tensor(
                torch.empty(shape_, device="meta"), dm,
                shd.to_placements(shd.P(*spec), mesh))

        x = place((Bt, St, d), baxes, None, None)
        w1 = place((d, f), None, "model").requires_grad_()   # column-parallel
        w2 = place((f, d), "model", None).requires_grad_()   # row-parallel
        counter = dryrun.DeviceCounter([t.to_local() for t in (x, w1, w2)])
        with implicit_replication(), counter:
            y = shard_act((x @ w1) @ w2, "batch", None, None)
            g1, g2 = torch.autograd.grad(y.sum(), [w1, w2], retain_graph=True)
            # the data-parallel gradient all-reduce, one per batch axis
            g1.redistribute(dm, w1.placements)
            g2.redistribute(dm, w2.placements)
    act = (Bt // dp) * St * d * 4                 # (B, S, d) a device
    grads = (d * f // tp + f // tp * d) * 4        # w1's and w2's shards
    c = counter.collectives
    assert c["all-reduce"] == act + len(baxes) * grads, c
    assert (c["all-gather"], c["reduce-scatter"], c["all-to-all"]) == (0, 0, 0)
    assert c["count"] == 1 + 2 * len(baxes)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "falcon-mamba-7b"])
def test_host_mesh_pass_b_equals_pass_a(arch):
    """On one device pass B's local FLOPs are pass A's, and so are its bytes
    where DTensor runs every op as it is (falcon-mamba's softplus gradient
    has no DTensor rule, and DTensor runs its decomposition: more ops)."""
    cfg = smoke_config(get_config(arch))
    rec = dryrun.run_cell(arch, ShapeConfig("s", S, 4, "train"),
                          mesh=HOST, cfg=cfg, num_microbatches=2)
    assert rec["device_flops"] == rec["hlo_flops"]
    if arch == "phi4-mini-3.8b":
        assert rec["device_bytes"] == rec["hlo_bytes"]
    else:
        assert rec["device_bytes"] > rec["hlo_bytes"]
    assert rec["collectives"]["count"] == 0
    assert rec["temp_size_in_bytes"] > 0


# -- records and roofline --------------------------------------------------------------
# The reference's record keys (src/repro/launch/dryrun.py, run_cell) but
# generated_code_size_in_bytes: nothing is compiled here.
REF_KEYS = {
    "arch", "shape", "kind", "mesh", "chips", "tag", "t_lower_s",
    "t_compile_s", "argument_size_in_bytes", "output_size_in_bytes",
    "temp_size_in_bytes", "scanned_collectives", "hlo_flops", "hlo_bytes",
    "t_lower_unrolled_s", "collectives", "collectives_method",
    "device_bytes", "device_flops", "params_total", "params_active",
    "model_flops", "tokens_per_step",
}


@pytest.fixture(scope="module")
def records():
    out = []
    for arch, kind in (("phi4-mini-3.8b", "decode"), ("olmoe-1b-7b", "train"),
                       ("recurrentgemma-2b", "prefill")):
        cfg = smoke_config(get_config(arch))
        out.append(dryrun.run_cell(
            arch, ShapeConfig("s", S, 4, kind), mesh=Mesh(("data", "model"),
                                                          (2, 2)), cfg=cfg))
    return out


def test_records_have_the_reference_keys(records):
    for rec in records:
        assert set(rec) == REF_KEYS
        assert rec["collectives_method"] == "exact(dtensor)"
        assert set(rec["collectives"]) == {
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "count"}


def test_roofline_equals_reference_at_h100_constants(records, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_PER_CHIP"):
        monkeypatch.setattr(jroof, name, getattr(roofline, name))
    for rec in records:
        ours, ref = roofline.analyze_record(rec), jroof.analyze_record(rec)
        assert ours is not None and ours.__dict__ == ref.__dict__
        assert ours.row() == ref.row()
    assert roofline.format_table([roofline.analyze_record(r) for r in records])


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.HBM_PER_CHIP) == (989e12, 3.35e12, 50e9, 80e9)


# -- the fake process group ---------------------------------------------------------
def test_fake_group_gone_after_return_and_raise(monkeypatch):
    dist = torch.distributed
    cfg = smoke_config(get_config("phi4-mini-3.8b"))
    shape = ShapeConfig("s", S, 4, "decode")
    mesh = Mesh(("data", "model"), (2, 2))
    dryrun.run_cell("phi4-mini-3.8b", shape, mesh=mesh, cfg=cfg)
    assert not dist.is_initialized()

    def boom(*a, **k):
        assert dist.is_initialized()
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "_run_step", boom)
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.run_cell("phi4-mini-3.8b", shape, mesh=mesh, cfg=cfg,
                        analyze=False)
    assert not dist.is_initialized()
    monkeypatch.undo()
    with dryrun.fake_process_group(4):
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.run_cell("phi4-mini-3.8b", shape, mesh=mesh, cfg=cfg,
                            analyze=False)
    assert not dist.is_initialized()
