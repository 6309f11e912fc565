"""The port's decode (KV cache + ``decode_step``) against the reference's on
``smoke_config(phi4-mini-3.8b)``, with the reference's params converted by
``repro_torch.models.convert``.

The port's decode attention goes through ``ops.flash_attention`` over the
cache slots that hold positions (the plain version on the CPU); the reference's runs
``_sdpa`` over the whole cache with a slot mask. Tolerances: float32 1e-5
(the same function, another summation order); bfloat16 2e-2 (the reference
rounds the probabilities to bf16 before PV, the port keeps them in fp32).
In bfloat16 the caches of later layers are compared at 2e-2 of the cache's
largest magnitude: their inputs carry the earlier layers' rounding, and an
element near zero can differ by a few bf16 steps of its neighbours.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs.base import ATTN, DENSE, LayerSpec  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    decode_state_from_reference,
    from_reference,
)

B, BUDGET, STEPS = 2, 8, 6


def _cfgs(**kw):
    return (jsmoke(jget_config("phi4-mini-3.8b")).replace(**kw),
            smoke_config(get_config("phi4-mini-3.8b")).replace(**kw))


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(B, STEPS)).astype(np.int32)


def _ref_layer_caches(state, cfg):
    """The reference's caches unstacked into schedule order (NumPy)."""
    pattern, nb, _ = cfg.scan_split()
    out = []
    for bi in range(nb):
        for i in range(len(pattern)):
            c = state.blocks[i]
            out.append(tuple(np.asarray(a)[bi] for a in (c.k, c.v, c.slot_pos)))
    out.extend(tuple(np.asarray(a) for a in (c.k, c.v, c.slot_pos))
               for c in state.tail)
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_decode_steps_match_reference_logits_and_cache(ref_params, dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks = _tokens()
    js = jm.init_decode_state(ref_params, B, BUDGET)
    ts = tm.init_decode_state(tp, B, BUDGET)
    for t in range(STEPS):
        jl, js = jm.decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
        _close(tl, jl, tol)
    assert ts.pos == int(js.pos) == STEPS
    want = _ref_layer_caches(js, jcfg)
    assert len(ts.layers) == len(want) == tcfg.num_layers
    for c, (k, v, slot_pos) in zip(ts.layers, want):
        # The port's cache keeps position p in slot p, as the reference's
        # ring does until it wraps.
        np.testing.assert_array_equal(
            slot_pos, np.r_[np.arange(STEPS), -np.ones(BUDGET - STEPS)])
        for got, ref in ((c.k, k), (c.v, v)):
            ref = np.asarray(ref, np.float32)
            if dtype == "float32":
                _close(got, ref, tol)
            else:
                err = np.abs(got.float().numpy() - ref).max()
                assert err <= tol * np.abs(ref).max(), err


def test_converted_reference_state_decodes_on(ref_params):
    # Both packages start the last three steps from the reference's cache.
    jcfg, tcfg = _cfgs(dtype="float32")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks = _tokens(1)
    js = jm.init_decode_state(ref_params, B, BUDGET)
    for t in range(3):
        _, js = jm.decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
    ts = decode_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                     device="cpu")
    assert ts.pos == 3
    for c, (k, v, _) in zip(ts.layers, _ref_layer_caches(js, jcfg)):
        np.testing.assert_array_equal(c.k.numpy(), k)
        np.testing.assert_array_equal(c.v.numpy(), v)
    for t in range(3, STEPS):
        jl, js = jm.decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        _close(tl, jl, 1e-5)


def test_decode_refuses_a_wrapping_ring_and_softcap():
    # A ring of 2 slots with no window wraps and decodes on, over the last
    # 2 positions as the reference's ring does. A ring wider than its
    # layer's window is refused once it would wrap (the kernel would mask
    # the window by slot index, not by position), and so is the softcap,
    # which the kernel does not compute.
    _, tcfg = _cfgs(dtype="float32")
    tm = build_model(tcfg)
    tp = tm.init(0, device="cpu")
    tok = {"tokens": torch.zeros((1, 1), dtype=torch.int32)}
    st = tm.init_decode_state(tp, 1, 2)
    for _ in range(3):
        logits, st = tm.decode(tp, st, tok)
    assert st.pos == 3 and bool(torch.isfinite(logits).all())
    wide = build_model(tcfg.replace(
        block_pattern=(LayerSpec(mixer=ATTN, ffn=DENSE, window=1),)))
    st = wide.init_decode_state(tp, 1, 2)
    for _ in range(2):
        _, st = wide.decode(tp, st, tok)
    with pytest.raises(ValueError, match="wrap"):
        wide.decode(tp, st, tok)
    capped = build_model(tcfg.replace(attn_logit_softcap=30.0))
    with pytest.raises(NotImplementedError, match="softcap"):
        capped.decode(tp, capped.init_decode_state(tp, 1, 4), tok)


def test_converting_a_wrapped_reference_ring_raises(ref_params):
    jcfg, tcfg = _cfgs(dtype="float32")
    jm = jbuild(jcfg)
    js = jax.tree.map(np.asarray, jm.init_decode_state(ref_params, B, BUDGET))
    js = js._replace(pos=np.int32(2))
    c = js.tail[0] if js.tail else js.blocks[0]
    # Slot 0 holds position BUDGET, as after a wrap; slot 1 position 1.
    sp = np.array(c.slot_pos)
    sp[..., 0], sp[..., 1] = BUDGET, 1
    wrapped = c._replace(slot_pos=sp)
    js = (js._replace(tail=[wrapped, *js.tail[1:]]) if js.tail
          else js._replace(blocks=(wrapped, *js.blocks[1:])))
    with pytest.raises(NotImplementedError, match="wrapped"):
        decode_state_from_reference(js, tcfg, device="cpu")
