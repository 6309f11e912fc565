"""The port's dense model against the reference on
``smoke_config(phi4-mini-3.8b)``, with the reference's params converted by
``repro_torch.models.convert``.

Tolerances: in float32 both sides do the same math in another order, so
loss and logits agree to rtol/atol 1e-5; in bfloat16 they round at other
places, so they agree to 2e-2, the bf16 tolerance of tests/test_kernels.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference, to_reference  # noqa: E402


def _cfgs(**kw):
    return (jsmoke(jget_config("phi4-mini-3.8b")).replace(**kw),
            smoke_config(get_config("phi4-mini-3.8b")).replace(**kw))


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _batch(B=2, S=32, V=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, size=(B, S)).astype(np.int32),
            rng.integers(0, V, size=(B, S)).astype(np.int32))


def test_configs_match_reference():
    jcfg, tcfg = _cfgs()
    assert {k: getattr(tcfg, k) for k in ("num_layers", "d_model", "num_heads",
                                          "num_kv_heads", "head_dim", "d_ff",
                                          "vocab_size", "tie_embeddings")} == \
        {k: getattr(jcfg, k) for k in ("num_layers", "d_model", "num_heads",
                                       "num_kv_heads", "head_dim", "d_ff",
                                       "vocab_size", "tie_embeddings")}
    full = get_config("phi4-mini-3.8b")
    assert full.param_counts() == jget_config("phi4-mini-3.8b").param_counts()


def test_converter_round_trips_exactly(ref_params):
    _, tcfg = _cfgs()
    tp = from_reference(ref_params, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers
    back = to_reference(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_port_init_has_reference_shapes():
    jcfg, tcfg = _cfgs()
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          jbuild(jcfg).abstract_params())
    port = to_reference(build_model(tcfg).init(3, device="cpu"), tcfg)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), port) == shapes


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("q_chunk,remat", [(2048, "dots"), (8, "none")])
def test_loss_and_logits_match_reference(ref_params, dtype, tol, q_chunk,
                                         remat):
    # q_chunk=8 < S=32 takes the q-chunked attention path on both sides.
    jcfg, tcfg = _cfgs(dtype=dtype, attn_q_chunk=q_chunk, remat_policy=remat)
    tokens, labels = _batch()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    jl, _ = jm.loss(ref_params, jb)
    tl, metrics = tm.loss(tp, tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=tol, atol=tol)
    assert float(metrics["aux"]) == 0.0
    jlog = np.asarray(jm.prefill_logits(ref_params, {"tokens": jb["tokens"]}),
                      dtype=np.float32)
    tlog = tm.prefill_logits(tp, {"tokens": tb["tokens"]}).float()
    assert tlog.shape == (2, 1, 256)
    np.testing.assert_allclose(tlog.detach().numpy(), jlog, rtol=tol, atol=tol)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError):
        build_model(smoke_config(get_config("phi4-mini-3.8b"))).init(0)
    with pytest.raises(RuntimeError):
        from_reference({}, smoke_config(get_config("phi4-mini-3.8b")))
