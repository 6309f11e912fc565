"""``train.checkpoint.restore_sharded`` of the port against the
reference's ``test_elastic_restore_sharded``: the same file restored onto a
one-rank ``("data",)`` mesh gives the reference's values with the spec's
placements, and at world size 4 (a fake process group at each rank) every
leaf's local block is the rank's slice of the saved tensor. Values are
compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.train import restore_sharded as jrestore_sharded  # noqa: E402
from repro.train import save_checkpoint as jsave  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.sharding import NamedSharding, P, param_specs, to_named, to_placements, tree_map  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import restore_sharded, restore_tree, save_checkpoint  # noqa: E402


def _mesh(world, rank=0):
    return fake_process_group(world, rank=rank)


def test_elastic_restore_sharded_matches_reference(tmp_path):
    """The reference's case: an (8, 8) fp32 leaf saved by the reference,
    restored by both onto a one-device ``P("data", None)``."""
    tree = {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)}
    path = str(tmp_path / "e.ckpt")
    jsave(path, tree, step=1)
    jmesh = jax.make_mesh((1,), ("data",))
    want, jstep = jrestore_sharded(
        path, tree, {"w": JNamedSharding(jmesh, JP("data", None))})
    with _mesh(1):
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        sh = {"w": NamedSharding(mesh, P("data", None))}
        got, step = restore_sharded(path, {"w": torch.zeros(8, 8)}, sh)
        assert step == jstep == 1
        assert got["w"].shape == (8, 8)
        assert got["w"].placements == (Replicate(),)   # an axis of size 1
        np.testing.assert_array_equal(got["w"].to_local().numpy(),
                                      np.asarray(want["w"]))
        np.testing.assert_array_equal(got["w"].full_tensor().numpy(),
                                      np.asarray(want["w"]))


@pytest.mark.parametrize("rank", range(4))
def test_local_slices_at_world_size_4(tmp_path, rank):
    """Four ranks: a row-sharded leaf gives each rank its two rows, a
    replicated one the whole leaf, a None sharding a plain tensor and an
    int stays an int."""
    w = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    b = torch.arange(6, dtype=torch.bfloat16)
    like = {"w": w, "b": b, "step": 3, "plain": torch.ones(3)}
    path = str(tmp_path / "w4.ckpt")
    save_checkpoint(path, like, step=5)
    with _mesh(4, rank):
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
        sh = {"w": NamedSharding(mesh, P("data", None)),
              "b": NamedSharding(mesh, P(None)), "step": None, "plain": None}
        got, step = restore_sharded(path, like, sh)
        assert step == 5 and got["step"] == 3
        assert got["w"].placements == (Shard(0),)
        assert torch.equal(got["w"].to_local(), w[2 * rank:2 * rank + 2])
        assert got["b"].placements == (Replicate(),)
        assert torch.equal(got["b"].to_local(), b)
        assert type(got["plain"]) is torch.Tensor
        assert torch.equal(got["plain"], torch.ones(3))


def test_model_params_onto_param_specs(tmp_path):
    """A smoke phi4-mini's params onto ``param_specs`` over a one-rank
    mesh (as the card's check does at full width): each leaf's local block
    is ``restore_tree``'s leaf, its placements those of its spec."""
    cfg = smoke_config(get_config("phi4-mini-3.8b"))
    params = build_model(cfg).init(0, device="cpu")
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, params, step=2)
    specs = param_specs(params, Mesh(("data",), (1,)), cfg)
    plain, _ = restore_tree(path, params)
    with _mesh(1):
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        placed, step = restore_sharded(path, params, to_named(specs, mesh))
        trio = []
        tree_map(lambda d, t, s: trio.append((d, t, s)), placed, plain, specs)
        assert step == 2 and len(trio) > 10
        for d, t, s in trio:
            assert d.placements == tuple(to_placements(s, Mesh(("data",),
                                                               (1,))))
            assert torch.equal(d.to_local(), t)


@pytest.mark.parametrize("case", ["renamed", "extra", "missing", "nested"])
def test_mismatched_shardings_tree_raises_as_the_reference(tmp_path, case):
    """A shardings tree of another structure than ``like``'s: the reference
    raises ``ValueError`` (``flatten_up_to``); so does the port, naming the
    first leaf where they part, before any read."""
    tree = {"a": jnp.arange(8, dtype=jnp.float32),
            "b": {"c": jnp.ones((2, 2), jnp.float32)}}
    path = str(tmp_path / "m.ckpt")
    jsave(path, tree, step=1)
    jmesh = jax.make_mesh((1,), ("data",))
    jsh = JNamedSharding(jmesh, JP())
    jshard = {"renamed": {"a": jsh, "d": {"c": jsh}},
              "extra": {"a": jsh, "b": {"c": jsh, "e": jsh}},
              "missing": {"a": jsh},
              "nested": {"a": {"x": jsh}, "b": {"c": jsh}}}[case]
    if case != "nested":       # the reference flattens shardings up to like
        with pytest.raises(ValueError):
            jrestore_sharded(path, tree, jshard)
    like = {"a": torch.zeros(8), "b": {"c": torch.zeros(2, 2)}}
    with _mesh(1):
        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
        sh = NamedSharding(mesh, P())
        shardings = {"renamed": {"a": sh, "d": {"c": sh}},
                     "extra": {"a": sh, "b": {"c": sh, "e": sh}},
                     "missing": {"a": sh},
                     "nested": {"a": {"x": sh}, "b": {"c": sh}}}[case]
        with pytest.raises(ValueError, match="structure"):
            restore_sharded(path, like, shardings)
        got, step = restore_sharded(path, like, {"a": sh, "b": {"c": None}})
        assert step == 1 and torch.equal(got["b"]["c"], torch.ones(2, 2))
