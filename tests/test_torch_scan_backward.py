"""The gradients of the port's three differentiated scan entries on the CPU:
``ops.mamba_scan`` (the literal selective scan), ``ops.mamba_scan_fused``
and ``ops.rglru_scan_gated``. Each is a ``torch.autograd.Function``
(``kernels/mamba_scan.py``, ``kernels/rglru_scan.py``) whose backward is a
CUDA kernel on the card and, on CPU tensors, the plain backward of
``kernels/ref.py`` (``ssm_scan_bwd_ref``, ``mamba_scan_fused_bwd_ref``,
``rglru_scan_gated_bwd_ref``), which these tests hold:

* against autograd of the plain forward, float32 at 1e-5 relative (the
  same ops differentiated by hand), and by ``torch.autograd.gradcheck``
  through the Function in float64 on tiny shapes;
* against ``jax.grad`` of the reference's own functions on the same NumPy
  inputs: ``_chunked_scan`` read out with C, ``_fused_chunk_scan`` with its
  skip and gate, ``_gates`` with an associative scan and the output
  product; float32 at 1e-4 for Mamba (the reference's scan tolerance) and
  1e-5 for the RG-LRU, bfloat16 at 2e-2 of each gradient's largest
  magnitude (one bf16 step of the gradients and of the operands the
  forward rounds), but the fused Mamba's dt_pre and dt_bias at the fused
  forward's 5e-2 (``BF16_DT_TOL``);
* the Function's forward on the CPU against the plain forward, bitwise,
  and its refusal of a gradient through the returned state;
* the smoke models' loss gradients against ``jax.grad`` of the reference's
  loss: falcon-mamba in both ``ssm_impl`` values and recurrentgemma,
  float32 at 1e-5 of each leaf's largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.rglru import _gates as jgates  # noqa: E402
from repro.models.ssm import _chunked_scan, _fused_chunk_scan  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as LRU  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference, to_reference  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SCAN_CASES = [(1, 1, 8, 4), (2, 17, 12, 4), (1, 37, 16, 8), (2, 9, 6, 16)]
FUSED_CASES = [  # (B, S, D, N, r, chunk): S % chunk != 0 but for S = 1
    (1, 1, 8, 4, 2, 4), (1, 37, 16, 4, 3, 8), (2, 17, 12, 8, 5, 16),
    (3, 9, 12, 2, 1, 4)]
LRU_CASES = [(1, 1, 8), (1, 37, 16), (2, 17, 24), (3, 9, 50)]   # (B, S, W)


def _rng(seed):
    return np.random.default_rng(seed)


def _scan_np(B, S, D, N, seed):
    r = _rng(seed)
    return {"Abar": 1.0 / (1.0 + np.exp(-r.standard_normal((B, S, D, N)))),
            "Bx": r.standard_normal((B, S, D, N)) * 0.1,
            "C": r.standard_normal((B, S, N)),
            "h0": r.standard_normal((B, D, N)) * 0.5,
            "gy": r.standard_normal((B, S, D))}


def _fused_np(B, S, D, N, r_, seed):
    r = _rng(seed)
    f = lambda *s: r.standard_normal(s)  # noqa: E731
    return {"xin": f(B, S, D), "dt_pre": f(B, S, D) * 0.5,
            "dt_bias": np.log(np.expm1(1e-2)) + f(D) * 0.1,
            "A_log": np.log(np.tile(np.arange(1, N + 1.0), (D, 1)))
            + f(D, N) * 0.1,
            "proj": f(B, S, r_ + 2 * N), "Dskip": 1.0 + f(D) * 0.1,
            "z": f(B, S, D), "h0": f(B, D, N) * 0.5, "gy": f(B, S, D)}


def _lru_np(B, S, W, seed):
    r = _rng(seed)
    f = lambda *s: r.standard_normal(s)  # noqa: E731
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, W)) / 8.0))
    return {"xr": f(B, S, W), "w_r": f(W, W) / np.sqrt(W),
            "w_i": f(W, W) / np.sqrt(W), "b_r": f(W) * 0.1,
            "b_i": f(W) * 0.1, "lam": lam, "gate": f(B, S, W),
            "h0": f(B, W) * 0.5, "gy": f(B, S, W)}


FUSED_KEYS = ("xin", "dt_pre", "dt_bias", "A_log", "proj", "Dskip", "z")
# In bf16 the gradients that reach softplus's input (dt_pre, dt_bias) are
# held at 5e-2 of their scale against the reference, the bound of the
# fused forward's bf16 test (tests/test_torch_scan_fused.py): the two
# frameworks round softplus and its derivative to bf16 at other places, and
# one bf16 step of dt (2^-5 near dt_bias) moves it by 3 %; on a CPU run
# these two gradients differed by up to 2.1 % of their scale, every other
# one by under 0.9 %.
BF16_DT_TOL = 5e-2
ACTS = ("xin", "dt_pre", "proj", "z", "xr", "gate", "gy")


def _t(inp, keys, dtype=torch.float32, grad=False):
    """Torch tensors of ``keys``: activations in ``dtype``, the rest fp32
    (float64 when ``dtype`` is)."""
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    out = [torch.tensor(inp[k], dtype=dtype if k in ACTS else wide)
           for k in keys]
    return [t.requires_grad_() for t in out] if grad else out


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().double().numpy(),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _close_to_scale(got, want, tol):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err,
                                                          np.abs(want).max())


# -- plain backward against autograd of the plain forward ------------------------
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,N", SCAN_CASES)
def test_scan_bwd_ref_matches_autograd(B, S, D, N, with_h0):
    inp = _scan_np(B, S, D, N, seed=S + D)
    A, Bx, C, h0 = _t(inp, ("Abar", "Bx", "C", "h0"), grad=True)
    h0 = h0 if with_h0 else None
    gy = torch.tensor(inp["gy"], dtype=torch.float32)
    want = torch.autograd.grad(ref.ssm_scan_ref(A, Bx, C, h0),
                               [t for t in (A, Bx, C, h0) if t is not None],
                               gy)
    got = ref.ssm_scan_bwd_ref(gy, A.detach(), Bx.detach(), C.detach(),
                               None if h0 is None else h0.detach())
    assert (got[3] is None) == (h0 is None)
    for g, w in zip([g for g in got if g is not None], want, strict=True):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,N,r,chunk", FUSED_CASES)
def test_fused_bwd_ref_matches_autograd(B, S, D, N, r, chunk, with_h0):
    inp = _fused_np(B, S, D, N, r, seed=S + D)
    ts = _t(inp, FUSED_KEYS + ("h0",), grad=True)
    h0 = ts[7] if with_h0 else None
    gy = torch.tensor(inp["gy"], dtype=torch.float32)
    y = ref.mamba_scan_fused_ref(*ts[:7], h0)
    leaves = ts[:7] + ([h0] if with_h0 else [])
    want = torch.autograd.grad(y, leaves, gy)
    got = ref.mamba_scan_fused_bwd_ref(gy, *[t.detach() for t in ts[:7]],
                                       None if h0 is None else h0.detach())
    assert (got[7] is None) == (h0 is None)
    for g, w in zip([g for g in got if g is not None], want, strict=True):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,W", LRU_CASES)
def test_rglru_bwd_ref_matches_autograd(B, S, W, with_h0):
    inp = _lru_np(B, S, W, seed=S + W)
    inp["r_pre"] = inp["xr"] @ inp["w_r"]
    inp["i_pre"] = inp["xr"] @ inp["w_i"]
    keys = ("r_pre", "i_pre", "b_r", "b_i", "lam", "xr", "gate", "h0")
    ts = _t(inp, keys, grad=True)
    h0 = ts[7] if with_h0 else None
    gy = torch.tensor(inp["gy"], dtype=torch.float32)
    y = ref.rglru_scan_gated_ref(*ts[:7], h0)
    leaves = ts[:7] + ([h0] if with_h0 else [])
    want = torch.autograd.grad(y, leaves, gy)
    got = ref.rglru_scan_gated_bwd_ref(gy, *[t.detach() for t in ts[:7]],
                                       None if h0 is None else h0.detach())
    for g, w in zip([g for g in got if g is not None], want, strict=True):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("entry", ["mamba_scan", "mamba_scan_fused",
                                   "rglru_scan_gated"])
def test_gradcheck_through_the_function_in_float64(entry):
    f64 = torch.float64
    if entry == "mamba_scan":
        inp = _scan_np(2, 5, 3, 2, seed=1)
        ts = _t(inp, ("Abar", "Bx", "C", "h0"), f64, grad=True)
        fn = lambda *a: MS.MambaScanFn.apply(False, *a, False)[0]  # noqa: E731
    elif entry == "mamba_scan_fused":
        inp = _fused_np(2, 5, 3, 2, 1, seed=2)
        ts = _t(inp, FUSED_KEYS + ("h0",), f64, grad=True)
        fn = lambda *a: MS.MambaScanFusedFn.apply(False, *a, False)[0]  # noqa: E731
    else:
        inp = _lru_np(2, 5, 3, seed=3)
        inp["r_pre"] = inp["xr"] @ inp["w_r"]
        inp["i_pre"] = inp["xr"] @ inp["w_i"]
        ts = _t(inp, ("r_pre", "i_pre", "b_r", "b_i", "lam", "xr", "gate",
                      "h0"), f64, grad=True)
        fn = lambda *a: LRU.RGLRUScanGatedFn.apply(False, *a, False)[0]  # noqa: E731
    assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-6, rtol=1e-5)


# -- against jax.grad of the reference's functions --------------------------------
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,N", SCAN_CASES)
def test_scan_gradient_matches_jax_grad_of_chunked_scan(B, S, D, N, with_h0):
    inp = {k: v.astype(np.float32) for k, v in _scan_np(B, S, D, N,
                                                        seed=3 * S).items()}

    def f(A, Bx, C, h0):
        h, _ = _chunked_scan(A, Bx, 8, h0)
        return jnp.einsum("bsin,bsn->bsi", h, C)

    args = [jnp.asarray(inp[k]) for k in ("Abar", "Bx", "C")]
    h0 = (jnp.asarray(inp["h0"]) if with_h0 else
          jnp.zeros((B, D, N), jnp.float32))
    _, vjp = jax.vjp(f, *args, h0)
    want = vjp(jnp.asarray(inp["gy"]))
    ts = _t(inp, ("Abar", "Bx", "C", "h0"), grad=True)
    y = ops.mamba_scan(*ts[:3], h0=ts[3] if with_h0 else None)
    y.backward(torch.from_numpy(inp["gy"]))
    for t, w in zip(ts[:3] + ([ts[3]] if with_h0 else []), want):
        _close(t.grad, w, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N,r,chunk", FUSED_CASES)
def test_fused_gradient_matches_jax_grad_of_fused_chunk_scan(B, S, D, N, r,
                                                             chunk, dtype):
    tdt, jdt = DTYPES[dtype]
    inp = {k: v.astype(np.float32) for k, v in _fused_np(B, S, D, N, r,
                                                         seed=S * D).items()}

    def f(xin, dt_pre, dt_bias, A_log, proj, Dskip, z):
        dt = jax.nn.softplus(dt_pre + dt_bias.astype(jdt)).astype(jnp.float32)
        A = -jnp.exp(A_log)
        y = _fused_chunk_scan(dt, proj[..., r:r + N], proj[..., r + N:], xin,
                              A, chunk).astype(jdt)
        return (y + Dskip.astype(jdt) * xin) * jax.nn.silu(z)

    args = [jnp.asarray(inp[k]).astype(jdt if k in ACTS else jnp.float32)
            for k in FUSED_KEYS]
    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(inp["gy"]).astype(jdt))
    ts = _t(inp, FUSED_KEYS, tdt, grad=True)
    y = ops.mamba_scan_fused(*ts)
    y.backward(torch.from_numpy(inp["gy"]).to(tdt))
    for key, t, w in zip(FUSED_KEYS, ts, want, strict=True):
        assert t.grad.dtype == t.dtype
        if dtype == "float32":
            _close(t.grad, np.asarray(w, np.float32), 1e-4)
        else:
            _close_to_scale(t.grad, np.asarray(w, np.float32),
                            BF16_DT_TOL if key in ("dt_pre", "dt_bias")
                            else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", LRU_CASES)
def test_rglru_gradient_matches_jax_grad_of_gates_and_scan(B, S, W, dtype):
    tdt, jdt = DTYPES[dtype]
    inp = {k: v.astype(np.float32) for k, v in _lru_np(B, S, W,
                                                       seed=7 * S).items()}
    keys = ("xr", "w_r", "w_i", "b_r", "b_i", "lam", "gate")

    def f(xr, w_r, w_i, b_r, b_i, lam, gate):
        a, bx = jgates({"w_r": w_r, "w_i": w_i, "b_r": b_r, "b_i": b_i,
                        "lam": lam}, xr)

        def combine(left, right):
            return left[0] * right[0], left[1] * right[0] + right[1]

        _, h = jax.lax.associative_scan(combine, (a, bx), axis=1)
        return h.astype(jdt) * gate

    args = [jnp.asarray(inp[k]).astype(jdt if k in ACTS else jnp.float32)
            for k in keys]
    _, vjp = jax.vjp(f, *args)
    want = vjp(jnp.asarray(inp["gy"]).astype(jdt))
    ts = _t(inp, keys, tdt, grad=True)
    xr, w_r, w_i, b_r, b_i, lam, gate = ts
    xf = xr.float()
    y = ops.rglru_scan_gated(xf @ w_r, xf @ w_i, b_r, b_i, lam, xr, gate)
    y.backward(torch.from_numpy(inp["gy"]).to(tdt))
    for t, w in zip(ts, want, strict=True):
        assert t.grad.dtype == t.dtype
        if dtype == "float32":
            _close(t.grad, np.asarray(w, np.float32), 1e-5)
        else:
            _close_to_scale(t.grad, np.asarray(w, np.float32), 2e-2)


# -- the Functions on the CPU ---------------------------------------------------
def test_functions_forward_is_the_plain_forward_and_refuse_state_grads():
    s = {k: v.astype(np.float32) for k, v in _scan_np(2, 9, 6, 4, 5).items()}
    A, Bx, C, h0 = _t(s, ("Abar", "Bx", "C", "h0"), grad=True)
    y, h = MS.MambaScanFn.apply(False, A, Bx, C, h0, True)
    y_ref, h_ref = ref.ssm_scan_ref(A.detach(), Bx.detach(), C.detach(),
                                    h0.detach(), return_state=True)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    with pytest.raises(NotImplementedError, match="returned state"):
        (y.sum() + h.sum()).backward()

    fz = {k: v.astype(np.float32) for k, v in _fused_np(2, 9, 6, 4, 3,
                                                        6).items()}
    for dtype in (torch.float32, torch.bfloat16):
        ts = _t(fz, FUSED_KEYS + ("h0",), dtype, grad=True)
        y, h = ops.mamba_scan_fused(*ts[:7], h0=ts[7], return_state=True)
        y_ref, h_ref = ref.mamba_scan_fused_ref(
            *[t.detach() for t in ts], return_state=True)
        assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
        with pytest.raises(NotImplementedError, match="returned state"):
            (y.float().sum() + h.sum()).backward()

    lr = {k: v.astype(np.float32) for k, v in _lru_np(2, 9, 6, 7).items()}
    lr["r_pre"], lr["i_pre"] = lr["xr"] @ lr["w_r"], lr["xr"] @ lr["w_i"]
    keys = ("r_pre", "i_pre", "b_r", "b_i", "lam", "xr", "gate", "h0")
    for dtype in (torch.float32, torch.bfloat16):
        ts = _t(lr, keys, dtype, grad=True)
        y, h = ops.rglru_scan_gated(*ts[:7], h0=ts[7], return_state=True)
        y_ref, h_ref = ref.rglru_scan_gated_ref(
            *[t.detach() for t in ts], return_state=True)
        assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
        with pytest.raises(NotImplementedError, match="returned state"):
            (y.float().sum() + h.sum()).backward()
    # With no gradient needed the entries take no Function at all.
    with torch.no_grad():
        y, h = ops.rglru_scan_gated(*ts[:7], h0=ts[7], return_state=True)
    assert y.grad_fn is None and h.grad_fn is None


def test_functions_save_the_inputs_not_the_states():
    s = {k: v.astype(np.float32) for k, v in _scan_np(2, 9, 6, 4, 8).items()}
    A, Bx, C = _t(s, ("Abar", "Bx", "C"), grad=True)
    y = ops.mamba_scan(A, Bx, C)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and all(
        a is b for a, b in zip(saved, (A, Bx, C)))


# -- the smoke models' gradients ---------------------------------------------------
@pytest.mark.parametrize("arch,impl", [("falcon-mamba-7b", "materialized"),
                                       ("falcon-mamba-7b", "fused"),
                                       ("recurrentgemma-2b", None)])
def test_model_gradients_match_jax_grad(arch, impl):
    kw = {"dtype": "float32", **({"ssm_impl": impl} if impl else {})}
    jcfg = jsmoke(jget_config(arch)).replace(**kw)
    tcfg = smoke_config(get_config(arch)).replace(**kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    ref_p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    toks = _rng(3).integers(0, 256, size=(2, 40)).astype(np.int32)
    labels = _rng(4).integers(0, 256, size=(2, 40)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, jbatch)[0])(
        jax.tree.map(jnp.asarray, ref_p))
    tp = from_reference(ref_p, tcfg, device="cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_()
    tloss = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(labels)})[0]
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5, atol=1e-5)
    grads = to_reference(jax.tree.map(lambda t: t.grad, tp), tcfg)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads),
                    strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
