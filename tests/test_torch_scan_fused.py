"""The fused scan entries of the port against the reference, on the CPU.

``ops.mamba_scan_fused`` and ``ops.rglru_scan_gated`` take a recurrent
layer from its projections to its gated output. On CPU tensors they run
the plain versions of ``kernels/ref.py``, which these tests hold to:

* the reference's fused Mamba path (``repro.models.ssm._fused_chunk_scan``
  with its skip and gate) at S not a multiple of the chunk, float32 at
  1e-5 (another summation order) and bfloat16 at 5e-2 of the output's
  scale (dt rounded to bf16 before softplus moves a state by a few % of
  its scale; see ``test_torch_ssm.py``);
* one decode step from a random state against the reference's
  ``mamba_decode`` arithmetic (``y`` and ``h``);
* the reference's RG-LRU path (``repro.models.rglru._gates``, an
  associative scan, ``h.astype(dtype) * gate``) over a sequence and as one
  ``rglru_decode`` step, float32 at 1e-5;
* the port's own composition before the fusion (the discretization or
  gates as torch ops around ``ref.ssm_scan_ref`` / ``ref.lru_scan_ref``),
  bitwise;
* gradients through the plain versions;
* the CUDA wrappers' checks of dtype, shape and layout, which run before
  the device check and before any build.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models.rglru import _gates as jgates  # noqa: E402
from repro.models.ssm import _fused_chunk_scan  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402
from repro_torch.kernels import rglru_scan as LRU  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
MAMBA_CASES = [  # (B, S, D, N, r, chunk): S % chunk != 0
    (1, 37, 16, 4, 3, 8),
    (2, 50, 24, 8, 5, 16),
    (1, 70, 8, 16, 8, 32),
    (3, 9, 12, 2, 1, 4),
]
LRU_CASES = [(1, 37, 16), (2, 64, 24), (3, 9, 50)]   # (B, S, W)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _close_to_scale(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _mamba_inputs(B, S, D, N, r, seed, h0=False):
    """NumPy fp32 inputs at the model's scales: dt_pre near 0 so that dt
    sits near softplus(dt_bias = log(expm1(0.01)))."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    out = {
        "xin": f(B, S, D),
        "dt_pre": f(B, S, D) * 0.5,
        "dt_bias": np.full((D,), np.log(np.expm1(1e-2)), np.float32)
        + f(D) * 0.1,
        "A_log": np.log(np.tile(np.arange(1, N + 1, dtype=np.float32),
                                (D, 1))) + f(D, N) * 0.1,
        "proj": f(B, S, r + 2 * N),
        "Dskip": 1.0 + f(D) * 0.1,
        "z": f(B, S, D),
    }
    if h0:
        out["h0"] = f(B, D, N) * 0.5
    return {k: v.astype(np.float32) for k, v in out.items()}


def _torch_mamba(inp, dtype):
    """Torch tensors: activations in ``dtype``, parameters and h0 fp32."""
    acts = ("xin", "dt_pre", "proj", "z")
    return {k: torch.from_numpy(v).to(dtype) if k in acts else
            torch.from_numpy(v) for k, v in inp.items()}


def _jax_mamba_reference(inp, jdtype, N, r, chunk):
    """The reference's fused prefill path (``mamba_apply`` with
    ``impl="fused"`` after its projections)."""
    c = lambda k: jnp.asarray(inp[k]).astype(jdtype)  # noqa: E731
    xin, proj = c("xin"), c("proj")
    dt = jax.nn.softplus(c("dt_pre") + jnp.asarray(inp["dt_bias"]).astype(
        jdtype)).astype(jnp.float32)
    A = -jnp.exp(jnp.asarray(inp["A_log"]))
    Bc, Cc = proj[..., r:r + N], proj[..., r + N:]
    y = _fused_chunk_scan(dt, Bc, Cc, xin, A, chunk).astype(jdtype)
    y = y + jnp.asarray(inp["Dskip"]).astype(jdtype) * xin
    return y * jax.nn.silu(c("z"))


def _fused_args(t):
    return (t["xin"], t["dt_pre"], t["dt_bias"], t["A_log"], t["proj"],
            t["Dskip"], t["z"])


# -- (a) -----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N,r,chunk", MAMBA_CASES)
def test_mamba_fused_matches_reference_fused_chunk_scan(B, S, D, N, r, chunk,
                                                        dtype):
    tdt, jdt = DTYPES[dtype]
    inp = _mamba_inputs(B, S, D, N, r, seed=S + D)
    got = ops.mamba_scan_fused(*_fused_args(_torch_mamba(inp, tdt)))
    assert got.shape == (B, S, D) and got.dtype == tdt
    want = np.asarray(_jax_mamba_reference(inp, jdt, N, r, chunk), np.float32)
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        _close_to_scale(got, want, 5e-2)


# -- (b) -----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_fused_decode_step_matches_reference_decode(dtype):
    tdt, jdt = DTYPES[dtype]
    B, D, N, r = 3, 40, 16, 6
    inp = _mamba_inputs(B, 1, D, N, r, seed=11, h0=True)
    t = _torch_mamba(inp, tdt)
    y, h = ops.mamba_scan_fused(*_fused_args(t), h0=t["h0"],
                                return_state=True)
    assert y.shape == (B, 1, D) and h.shape == (B, D, N)
    # The reference's mamba_decode after its projections, on (B, D).
    c = lambda k: jnp.asarray(inp[k][:, 0]).astype(jdt)  # noqa: E731
    xin, proj = c("xin"), c("proj")
    dt = jax.nn.softplus(c("dt_pre") + jnp.asarray(inp["dt_bias"]).astype(
        jdt)).astype(jnp.float32)
    A = -jnp.exp(jnp.asarray(inp["A_log"]))
    Bc, Cc = proj[:, r:r + N], proj[:, r + N:]
    Abar = jnp.exp(dt[..., None] * A)
    Bx = (dt[..., None] * Bc[:, None, :].astype(jnp.float32)
          * xin[..., None].astype(jnp.float32))
    hw = Abar * jnp.asarray(inp["h0"]) + Bx
    yw = jnp.einsum("bin,bn->bi", hw, Cc.astype(jnp.float32)).astype(jdt)
    yw = (yw + jnp.asarray(inp["Dskip"]).astype(jdt) * xin) * jax.nn.silu(
        c("z"))
    if dtype == "float32":
        _close(y[:, 0], yw, 1e-5)
        _close(h, hw, 1e-5)
    else:
        _close_to_scale(y[:, 0], yw, 5e-2)
        _close_to_scale(h, hw, 5e-2)


# -- (c) -----------------------------------------------------------------------
def _lru_inputs(B, S, W, seed, h0=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, W,
                                              dtype=np.float32)) / 8.0))
    out = {"xr": f(B, S, W), "gate": f(B, S, W),
           "w_r": f(W, W) / np.sqrt(W), "w_i": f(W, W) / np.sqrt(W),
           "b_r": f(W) * 0.1, "b_i": f(W) * 0.1,
           "lam": lam.astype(np.float32)}
    if h0:
        out["h0"] = f(B, W) * 0.5
    return {k: v.astype(np.float32) for k, v in out.items()}


def _lru_port(inp, tdt, S=slice(None)):
    """The port's gated call as ``models/rglru.py`` makes it."""
    xr = torch.from_numpy(inp["xr"][:, S]).to(tdt)
    gate = torch.from_numpy(inp["gate"][:, S]).to(tdt)
    xf = xr.float()
    p = {k: torch.from_numpy(inp[k]) for k in ("w_r", "w_i", "b_r", "b_i",
                                                "lam")}
    h0 = torch.from_numpy(inp["h0"]) if "h0" in inp else None
    return ops.rglru_scan_gated(xf @ p["w_r"], xf @ p["w_i"], p["b_r"],
                                p["b_i"], p["lam"], xr, gate, h0=h0,
                                return_state=True)


def _lru_jparams(inp):
    return {k: jnp.asarray(inp[k]) for k in ("w_r", "w_i", "b_r", "b_i",
                                             "lam")}


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


@pytest.mark.parametrize("B,S,W", LRU_CASES)
def test_rglru_gated_matches_reference_gates_and_scan(B, S, W):
    inp = _lru_inputs(B, S, W, seed=S + W)
    y, h = _lru_port(inp, torch.float32)
    assert y.shape == (B, S, W) and h.shape == (B, W)
    a, bx = jgates(_lru_jparams(inp), jnp.asarray(inp["xr"]))
    _, hw = jax.lax.associative_scan(_combine, (a, bx), axis=1)
    _close(y, hw * jnp.asarray(inp["gate"]), 1e-5)
    _close(h, hw[:, -1], 1e-5)


def test_rglru_gated_decode_step_matches_reference_decode():
    inp = _lru_inputs(3, 1, 24, seed=5, h0=True)
    y, h = _lru_port(inp, torch.float32)
    a, bx = jgates(_lru_jparams(inp), jnp.asarray(inp["xr"][:, 0]))
    hw = a * jnp.asarray(inp["h0"]) + bx
    _close(h, hw, 1e-5)
    _close(y[:, 0], hw * jnp.asarray(inp["gate"][:, 0]), 1e-5)


# -- (d) -----------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_fused_plain_is_the_earlier_composition_bitwise(dtype, with_h0):
    tdt, _ = DTYPES[dtype]
    B, S, D, N, r = 2, 11, 20, 8, 4
    t = _torch_mamba(_mamba_inputs(B, S, D, N, r, seed=3, h0=with_h0), tdt)
    h0 = t.get("h0")
    y, h = ops.mamba_scan_fused(*_fused_args(t), h0=h0, return_state=True)
    # The model's discretization, scan and epilogue as separate torch ops.
    xin = t["xin"]
    Bc, Cc = t["proj"][..., r:r + N], t["proj"][..., r + N:]
    dt = F.softplus(t["dt_pre"] + t["dt_bias"].to(tdt)).float()
    Abar = torch.exp(dt[..., None] * -torch.exp(t["A_log"]))
    Bx = dt[..., None] * Bc[..., None, :].float() * xin[..., None].float()
    yw, hw = ref.ssm_scan_ref(Abar, Bx, Cc.float().contiguous(), h0,
                              return_state=True)
    yw = (yw.to(tdt) + t["Dskip"].to(tdt) * xin) * F.silu(t["z"])
    assert torch.equal(y, yw) and torch.equal(h, hw)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gated_plain_is_the_earlier_composition_bitwise(dtype, with_h0):
    tdt, _ = DTYPES[dtype]
    inp = _lru_inputs(2, 13, 16, seed=8, h0=with_h0)
    y, h = _lru_port(inp, tdt)
    xr = torch.from_numpy(inp["xr"]).to(tdt)
    gate = torch.from_numpy(inp["gate"]).to(tdt)
    p = {k: torch.from_numpy(v) for k, v in inp.items()}
    xf = xr.float()
    r = torch.sigmoid(xf @ p["w_r"] + p["b_r"])
    i = torch.sigmoid(xf @ p["w_i"] + p["b_i"])
    log_a = -8.0 * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    hw = ref.lru_scan_ref(a.contiguous(), (beta * i * xf).contiguous(),
                          p.get("h0"))
    assert torch.equal(y, hw.to(tdt) * gate) and torch.equal(h, hw[:, -1])


def test_fused_entries_with_no_steps_return_the_carried_state():
    t = _torch_mamba(_mamba_inputs(2, 0, 8, 4, 2, seed=1, h0=True),
                     torch.float32)
    y, h = ops.mamba_scan_fused(*_fused_args(t), h0=t["h0"],
                                return_state=True)
    assert y.shape == (2, 0, 8) and torch.equal(h, t["h0"])
    inp = _lru_inputs(2, 0, 8, seed=1, h0=True)
    y, h = _lru_port(inp, torch.float32)
    assert y.shape == (2, 0, 8) and torch.equal(h, torch.from_numpy(inp["h0"]))


# -- (e) -----------------------------------------------------------------------
def test_gradients_flow_through_the_plain_fused_versions():
    # The entries are autograd Functions whose backward takes dL/dy alone:
    # a gradient through the returned state h_S raises, as the dry run's
    # meta ops do; every input's gradient flows through y.
    t = _torch_mamba(_mamba_inputs(2, 6, 8, 4, 2, seed=2, h0=True),
                     torch.float32)
    for v in t.values():
        v.requires_grad_(True)
    y, h = ops.mamba_scan_fused(*_fused_args(t), h0=t["h0"],
                                return_state=True)
    with pytest.raises(NotImplementedError, match="returned state"):
        (y.square().sum() + h.sum()).backward(retain_graph=True)
    y.square().sum().backward()
    for k, v in t.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().sum() > 0, k
    inp = _lru_inputs(2, 5, 8, seed=2, h0=True)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in inp.items()}
    xf = p["xr"]
    y, h = ops.rglru_scan_gated(xf @ p["w_r"], xf @ p["w_i"], p["b_r"],
                                p["b_i"], p["lam"], p["xr"], p["gate"],
                                h0=p["h0"], return_state=True)
    with pytest.raises(NotImplementedError, match="returned state"):
        (y.square().sum() + h.sum()).backward(retain_graph=True)
    y.square().sum().backward()
    for k, v in p.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().sum() > 0, k


# -- (f) -----------------------------------------------------------------------
@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(K, "load_library", refuse)
    monkeypatch.setattr(K, "build", refuse)


def _bad_mamba_calls(t):
    good = dict(zip(("xin", "dt_pre", "dt_bias", "A_log", "proj", "Dskip",
                     "z"), _fused_args(t)))
    yield "bfloat16 or float32", {**good, "xin": good["xin"].double()}
    yield "dt_pre is", {**good, "dt_pre": good["dt_pre"].float()}
    yield "z shape", {**good, "z": good["z"][:, :-1]}
    yield "fewer than 2N", {**good, "proj": good["proj"][..., :3]}
    yield "state size", {**good, "A_log": torch.zeros(good["A_log"].shape[0],
                                                      3)}
    yield "A_log shape", {**good, "A_log": good["A_log"][:-1]}
    yield "dt_bias must be float32", {**good,
                                      "dt_bias": good["dt_bias"].double()}
    yield "Dskip must be contiguous", {**good,
                                       "Dskip": good["Dskip"].repeat(2)[::2]}
    yield "A_log must be contiguous", {
        **good, "A_log": good["A_log"].t().contiguous().t()}
    yield "one CUDA device", good


def _bad_lru_calls(p):
    good = dict(p)
    yield "bfloat16 or float32", {**good, "xr": good["xr"].half()}
    yield "gate", {**good, "gate": good["gate"][:, :-1]}
    yield "r_pre must be float32", {**good, "r_pre": good["r_pre"].double()}
    yield "lam shape", {**good, "lam": good["lam"][:-1]}
    yield "i_pre must be contiguous", {
        **good, "i_pre": good["i_pre"].transpose(0, 1).contiguous()
        .transpose(0, 1)}
    yield "one CUDA device", good


def test_cuda_wrappers_check_inputs_before_any_build(no_build):
    t = _torch_mamba(_mamba_inputs(2, 5, 16, 4, 3, seed=4, h0=True),
                     torch.bfloat16)
    n = 0
    for match, kw in _bad_mamba_calls(t):
        with pytest.raises(ValueError, match=match):
            MS.mamba_scan_fused_cuda(**kw, h0=t["h0"])
        n += 1
    with pytest.raises(ValueError, match="h0 shape"):
        MS.mamba_scan_fused_cuda(*_fused_args(t), h0=t["h0"][:, :-1])
    inp = _lru_inputs(2, 5, 16, seed=4, h0=True)
    xr = torch.from_numpy(inp["xr"]).to(torch.bfloat16)
    p = {"r_pre": torch.from_numpy(inp["xr"]), "i_pre":
         torch.from_numpy(inp["gate"]), "b_r": torch.from_numpy(inp["b_r"]),
         "b_i": torch.from_numpy(inp["b_i"]), "lam": torch.from_numpy(
             inp["lam"]), "xr": xr, "gate": xr.clone()}
    for match, kw in _bad_lru_calls(p):
        with pytest.raises(ValueError, match=match):
            LRU.rglru_scan_gated_cuda(**kw)
        n += 1
    assert n == 16


def test_launch_counts_cover_the_fused_entries():
    assert set(MS.LAUNCHES) == {"mamba_scan", "mamba_scan_fused",
                                "mamba_scan_backward",
                                "mamba_scan_fused_backward"}
    assert set(LRU.LAUNCHES) == {"rglru_scan", "rglru_scan_gated",
                                 "rglru_scan_gated_backward"}
    MS.LAUNCHES["mamba_scan_fused"] = 5
    LRU.LAUNCHES["rglru_scan_gated"] = 7
    MS.reset_launch_counts()
    LRU.reset_launch_counts()
    assert set(MS.LAUNCHES.values()) == {0} and set(LRU.LAUNCHES.values()) == {0}
    # The plain versions on the CPU launch nothing, nor do their backwards.
    t = _torch_mamba(_mamba_inputs(1, 3, 8, 4, 2, seed=0), torch.float32)
    ops.mamba_scan_fused(*_fused_args(t))
    _lru_port(_lru_inputs(1, 3, 8, seed=0), torch.float32)
    t["xin"].requires_grad_(True)
    ops.mamba_scan_fused(*_fused_args(t)).sum().backward()
    assert set(MS.LAUNCHES.values()) == {0} and set(LRU.LAUNCHES.values()) == {0}
