"""The port's packed checkpoints (``CKPT-CKIO-v1``) against the reference's.

The same tree written by either package gives the same file, byte for
byte (names, manifest, 128-byte leaf alignment, 4096-byte data offset,
tail pad), and each package restores the other's file, with and without a
CkIO session, bit-equal. A train state crosses through
``train_state_to_reference``, so a checkpoint of either driver names the
same leaves."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import restore_tree as jrestore_tree  # noqa: E402
from repro.train import save_checkpoint as jsave  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.train import (  # noqa: E402
    AsyncCheckpointer,
    init_opt_state,
    load_into,
    restore_sharded,
    restore_tree,
    save_checkpoint,
)


def _to_torch(a) -> torch.Tensor:
    """A reference leaf as a CPU tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t):
    """A port leaf as the reference's NumPy array (bf16 via ml_dtypes)."""
    if isinstance(t, int):
        return np.asarray(t, np.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _states(master: bool, arch: str = "phi4-mini-3.8b"):
    """The reference's smoke ``{"params", "opt"}`` of ``arch`` (bf16 params
    with fp32 masters when ``master``; seeded random moments, step 7) and
    the port's copy of it."""
    dtype = "bfloat16" if master else "float32"
    jcfg = jsmoke(jget_config(arch)).replace(param_dtype=dtype)
    tcfg = smoke_config(get_config(arch)).replace(param_dtype=dtype)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    jopt = jinit_opt(jp, master_weights=master)
    rng = np.random.default_rng(3)
    rand = lambda a: jnp.asarray(  # noqa: E731
        rng.standard_normal(a.shape).astype(np.float32))
    jopt = dict(jopt, mu=jax.tree.map(rand, jopt["mu"]),
                nu=jax.tree.map(rand, jopt["nu"]),
                step=jnp.asarray(7, jnp.int32))
    jstate = {"params": jp, "opt": jopt}
    tstate = train_state_from_reference(jax.tree.map(_to_torch, jstate), tcfg,
                                        device="cpu")
    return jstate, tstate, tcfg


def _tree_pair(case):
    """(reference tree, port tree) of one case."""
    if case == "mixed":          # the reference test's tree
        j = {"a": jnp.arange(1000, dtype=jnp.float32).reshape(10, 100),
             "nested": {"b": jnp.ones((7,), jnp.bfloat16),
                        "c": jnp.asarray(3, jnp.int32)}}
        return j, jax.tree.map(_to_torch, j)
    if case == "mixed_int":      # the same, the int32 scalar a Python int
        j, t = _tree_pair("mixed")
        t["nested"]["c"] = 3
        return j, t
    if case == "aligned":        # the last leaf ends on a 128-byte boundary
        j = {"w": jnp.arange(64, dtype=jnp.float32)}
        return j, jax.tree.map(_to_torch, j)
    if case == "odd":            # a 4-byte last leaf: the tail is padded
        j = {"w": jnp.arange(64, dtype=jnp.float32),
             "c": jnp.asarray(7, jnp.int32)}
        return j, jax.tree.map(_to_torch, j)
    jstate, tstate, tcfg = _states(master=case == "state_master",
                                   arch=STATE_ARCHS.get(case, "phi4-mini-3.8b"))
    return jstate, train_state_to_reference(tstate, tcfg)


# MoE train states: the router and the (E + pad, ...) expert leaves, and
# qwen2-moe's 4 padded and shared experts, cross the converter by name.
STATE_ARCHS = {"state_olmoe": "olmoe-1b-7b",
               "state_qwen2_moe": "qwen2-moe-a2.7b"}
CASES = ["mixed", "mixed_int", "aligned", "odd", "state", "state_master",
         *STATE_ARCHS]


@pytest.mark.parametrize("case", CASES)
def test_port_file_is_byte_identical_to_reference_file(tmp_path, case):
    j, t = _tree_pair(case)
    jsave(str(tmp_path / "ref.ckpt"), j, step=42)
    manifest = save_checkpoint(str(tmp_path / "port.ckpt"), t, step=42)
    ref = (tmp_path / "ref.ckpt").read_bytes()
    assert (tmp_path / "port.ckpt").read_bytes() == ref
    assert manifest["data_offset"] % 4096 == 0
    assert not (tmp_path / "port.ckpt.tmp").exists()


def _assert_same_leaves(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("use_ckio", [False, True])
@pytest.mark.parametrize("case", ["mixed", "odd", "state_master",
                                  *STATE_ARCHS])
def test_each_package_restores_the_others_file(tmp_path, case, use_ckio):
    j, t = _tree_pair(case)
    jsave(str(tmp_path / "ref.ckpt"), j, step=5)
    save_checkpoint(str(tmp_path / "port.ckpt"), t, step=6)
    # the port reads the reference's file into the port's structure
    got, step = restore_tree(str(tmp_path / "ref.ckpt"), t, use_ckio=use_ckio)
    assert step == 5
    _assert_same_leaves(jax.tree.map(_to_numpy, got),
                        jax.tree.map(_to_numpy, t))
    _assert_same_leaves(jax.tree.map(_to_numpy, got), j)
    # the reference reads the port's file
    back, step = jrestore_tree(str(tmp_path / "port.ckpt"), j,
                               use_ckio=use_ckio)
    assert step == 6
    _assert_same_leaves(back, j)


def test_restored_state_converts_back_to_the_port_layout(tmp_path):
    jstate, tstate, tcfg = _states(master=True)
    path = str(tmp_path / "s.ckpt")
    jsave(path, jstate, step=7)
    tree, step = restore_tree(path, train_state_to_reference(tstate, tcfg))
    got = train_state_from_reference(tree, tcfg, device="cpu")
    assert step == 7 and got["opt"]["step"] == 7
    assert sorted(got["opt"]) == ["master", "mu", "nu", "step"]
    _assert_same_leaves(jax.tree.map(_to_numpy, got),
                        jax.tree.map(_to_numpy, tstate))


@pytest.mark.parametrize("master", [False, True])
def test_reference_file_restores_into_the_live_state_in_place(tmp_path,
                                                              master):
    """Read without a like-tree (structure from the leaf names, host
    tensors), the reference's file is written into a port state's own
    tensors, whose earlier values do not matter."""
    jstate, tstate, tcfg = _states(master=master)
    path = str(tmp_path / "s.ckpt")
    jsave(path, jstate, step=7)
    tree, step = restore_tree(path)
    assert step == 7 and "tail" not in tree["params"]
    params = build_model(tcfg).init(1, device="cpu")
    live = {"params": params, "opt": init_opt_state(params,
                                                    master_weights=master)}
    ptrs = [t.data_ptr() for t in jax.tree.leaves(live)
            if isinstance(t, torch.Tensor)]
    got = train_state_from_reference(tree, tcfg, into=live)
    assert [t.data_ptr() for t in jax.tree.leaves(got)
            if isinstance(t, torch.Tensor)] == ptrs
    assert got["opt"]["step"] == 7
    _assert_same_leaves(jax.tree.map(_to_numpy, got),
                        jax.tree.map(_to_numpy, tstate))
    # a file of another layout does not fit
    with pytest.raises(ValueError):
        train_state_from_reference(
            tree, tcfg, into={"params": params,
                              "opt": init_opt_state(params,
                                                    master_weights=not master)})


def test_reference_layout_shares_nothing_with_the_state():
    """``train_state_to_reference`` gives host copies: an in-place step
    after it does not reach it."""
    _, tstate, tcfg = _states(master=True)
    tree = train_state_to_reference(tstate, tcfg)
    want = jax.tree.map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        else t, tree)
    for t in jax.tree.leaves(tstate):
        if isinstance(t, torch.Tensor):
            t.add_(1)
    _assert_same_leaves(jax.tree.map(_to_numpy, tree),
                        jax.tree.map(_to_numpy, want))


def test_load_into_checks_names_shapes_and_dtypes(tmp_path):
    path = str(tmp_path / "w.ckpt")
    save_checkpoint(path, {"w": torch.arange(4.0), "n": 3}, step=0)
    tree, _ = restore_tree(path)
    w = torch.zeros(4)
    got = load_into(tree, {"w": w, "n": 0})
    assert got["w"] is w and torch.equal(w, torch.arange(4.0))
    assert got["n"] == 3
    with pytest.raises(ValueError, match="expected"):
        load_into(tree, {"w": torch.zeros(4, dtype=torch.float64), "n": 0})
    with pytest.raises(KeyError):
        load_into(tree, {"v": torch.zeros(4), "n": 0})


def test_restore_tree_rejects_a_leaf_of_another_shape(tmp_path):
    path = str(tmp_path / "w.ckpt")
    save_checkpoint(path, {"w": torch.zeros(4)}, step=0)
    with pytest.raises(ValueError, match="expected"):
        restore_tree(path, {"w": torch.zeros(5)})
    with pytest.raises(KeyError):
        restore_tree(path, {"v": torch.zeros(4)})


def test_async_checkpointer_retention_and_latest(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path / "c"), keep=2)
    assert ck.latest() is None
    for step in (0, 3, 6, 9):
        ck.save({"w": torch.full((8,), float(step))}, step)
    ck.wait()
    assert ck.list_steps() == [6, 9]
    assert ck.latest() == ck.path_for(9)
    tree, step = restore_tree(ck.latest(), {"w": torch.zeros(8)})
    assert step == 9 and torch.equal(tree["w"], torch.full((8,), 9.0))
    assert [r["step"] for r in ck.records] == [0, 3, 6, 9]
    assert all(r["bytes"] == 128 and r["write_s"] >= 0 for r in ck.records)
    ck.shutdown()


def test_snapshot_is_not_changed_by_a_later_in_place_step(tmp_path,
                                                         monkeypatch):
    """``save`` copies every leaf before it returns: the in-place AdamW
    update of the next step must not reach the file being written. The
    writer is held until the update has run."""
    from repro_torch.train import checkpoint

    stepped = threading.Event()
    write = checkpoint.save_checkpoint

    def held_write(*a, **kw):
        assert stepped.wait(timeout=30)
        return write(*a, **kw)

    monkeypatch.setattr(checkpoint, "save_checkpoint", held_write)
    params = {"w": torch.arange(4096, dtype=torch.float32)}
    opt = init_opt_state(params)
    ck = AsyncCheckpointer(str(tmp_path / "c"), keep=3)
    ck.save({"params": params, "opt": opt}, 1)
    params["w"].add_(1.0)
    opt["mu"]["w"].fill_(5.0)
    stepped.set()
    ck.wait()
    tree, _ = restore_tree(ck.latest(), {"params": params, "opt": opt})
    assert torch.equal(tree["params"]["w"],
                       torch.arange(4096, dtype=torch.float32))
    assert torch.equal(tree["opt"]["mu"]["w"], torch.zeros(4096))
    assert tree["opt"]["step"] == 0
    ck.shutdown()


def test_restore_sharded_raises(tmp_path):
    """``restore_sharded`` restores now (tests/test_torch_restore_sharded.py
    holds it against the reference's); it raises where the shardings do not
    follow ``like``'s structure or a leaf is missing, and a None sharding
    gives a plain tensor."""
    path = str(tmp_path / "e.ckpt")
    save_checkpoint(path, {"w": torch.arange(8.0)}, step=1)
    with pytest.raises(ValueError, match="like's structure"):
        restore_sharded(path, {"w": torch.zeros(8)}, {"w": [None, None]})
    with pytest.raises(KeyError, match="missing leaves"):
        restore_sharded(path, {"v": torch.zeros(8)}, {"v": None})
    tree, step = restore_sharded(path, {"w": torch.zeros(8)}, {"w": None})
    assert step == 1 and type(tree["w"]) is torch.Tensor
    assert torch.equal(tree["w"], torch.arange(8.0))
