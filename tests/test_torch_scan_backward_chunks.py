"""The chunk algebra of the two chunked backward kernels, on the CPU.

``fused_bwd_kernel`` (the fused Mamba entry's gradient, with its summary
and carry kernels, ``csrc/mamba_scan.cu``) and ``lru_bwd_kernel`` (the
gated RG-LRU entry's, ``csrc/rglru_scan.cu``) cut the sequence into chunks
that start from zero and are joined by short carry walks in a fixed order.
No card and no kernel here: each decomposition is written plainly below,
at the chunk constants the wrappers expose for sizing their scratch
(``mamba_scan.FUSED_BWD_CHUNK`` / ``FUSED_BWD_SUBSEG``,
``rglru_scan.BWD_CHUNKS`` / ``BWD_STEPS``), and held

* against the plain backwards ``ref.mamba_scan_fused_bwd_ref`` and
  ``ref.rglru_scan_gated_bwd_ref``, with and without h0;
* against ``jax.grad`` of the reference's ``_fused_chunk_scan`` with its
  skip and gate, and of ``_gates`` with an associative scan and the output
  product;

at the tolerances of ``tests/test_torch_scan_backward.py``: float32 at 1e-4
(Mamba) and 1e-5 (RG-LRU) elementwise, bfloat16 at 2e-2 of each
gradient's largest magnitude, the fused Mamba's dt_pre and dt_bias at
5e-2. Against the plain backwards the lengths cover S = 1, a chunk less
one, a chunk, a chunk and one, and several segments with a ragged tail;
against jax.grad three of them. D and W are not multiples of a block's
channels. The wrappers' scratch sizes are held to their formulas.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models.rglru import _gates as jgates  # noqa: E402
from repro.models.ssm import _fused_chunk_scan  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as LRU  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
T, Q = MS.FUSED_BWD_CHUNK, MS.FUSED_BWD_SUBSEG
SEG, STEPS = LRU.BWD_SEGMENT, LRU.BWD_STEPS
# (B, S, D, N, r): S = 1, T - 1, T, T + 1, two chunks and a ragged
# sub-segment; D below a block's 128 channels and not a multiple of 8.
FUSED_CASES = [(2, 1, 12, 4, 3), (1, T - 1, 10, 8, 2), (2, T, 9, 4, 1),
               (1, T + 1, 12, 16, 3), (2, 2 * T + 3 * Q + 5, 6, 4, 2)]
# (B, S, W): S = 1, a chunk less one, a chunk, a chunk and one, a segment,
# two segments and a ragged tail; W not a multiple of the 32 lanes.
LRU_CASES = [(2, 1, 20), (1, STEPS - 1, 33), (2, STEPS, 10),
             (1, STEPS + 1, 50), (2, SEG, 12), (2, 2 * SEG + 37, 20)]
# Against jax.grad (compiled anew for each shape): S = 1, a chunk and one,
# several chunks or segments with a ragged tail. The long RG-LRU case runs
# at B = 1: at B = 2 the plain backward itself misses jax.grad's w_i
# gradient at 1e-5 (by 1.26e-5 at this seed), the test's own matmul chain
# summing 586 terms in another order; the decomposition misses it by as
# much, and both pass at B = 1.
FUSED_JAX_CASES = [FUSED_CASES[0], FUSED_CASES[3], FUSED_CASES[4]]
LRU_JAX_CASES = [(2, 1, 20), (1, STEPS + 1, 50), (1, 2 * SEG + 37, 20)]
BF16_DT_TOL = 5e-2
ACTS = ("xin", "dt_pre", "proj", "z", "xr", "gate", "gy")
FUSED_KEYS = ("xin", "dt_pre", "dt_bias", "A_log", "proj", "Dskip", "z")
LRU_KEYS = ("r_pre", "i_pre", "b_r", "b_i", "lam", "xr", "gate")


# -- the decompositions, written plainly -------------------------------------------
def mamba_chunked_bwd(gy, xin, dt_pre, dt_bias, A_log, proj, Dskip, z,
                      h0=None, chunk=T, subseg=Q):
    """The fused entry's gradient as the chunked kernels compute it: (1)
    each chunk of ``chunk`` steps from zero, its local end state, its local
    adjoint sum_u P_u dy_u Cc_u and its sum of dt; (2) the carry walks over
    the chunks, forward from h0 with the decays exp(A sum dt) and backward
    from 0; (3) each chunk from its carries, the state kept at every
    ``subseg``-step start, the sub-segments from the last to the first
    recomputed and walked back; the epilogue rounded where the plain
    backward rounds. Returns what ``mamba_scan_fused_backward_cuda`` does."""
    dtype = xin.dtype
    f32 = torch.float32
    rnd = lambda v: v.to(dtype).to(f32)  # noqa: E731
    B, S, D = xin.shape
    N = A_log.shape[1]
    r = proj.shape[-1] - 2 * N
    s = rnd(dt_pre.float() + rnd(dt_bias))
    dt = rnd(F.softplus(s))
    x = xin.float()
    zf = z.float()
    dyp = rnd(gy.float() * rnd(F.silu(zf)))
    Bc, Cc = proj[..., r:r + N].float(), proj[..., r + N:].float()
    A = -torch.exp(A_log)
    C = -(-S // chunk)
    spans = [(c * chunk, min(S, (c + 1) * chunk)) for c in range(C)]

    def step_abar(t):
        return torch.exp(dt[:, t, :, None] * A)

    def step_bx(t):
        return Bc[:, t, None, :] * (dt[:, t] * x[:, t])[..., None]

    # (1) the chunks from zero
    H, G, SD = [], [], []
    for t0, t1 in spans:
        hl = x.new_zeros((B, D, N))
        P = x.new_ones((B, D, N))
        gr = x.new_zeros((B, D, N))
        sd = x.new_zeros((B, D))
        for t in range(t0, t1):
            ab = step_abar(t)
            hl = ab * hl + step_bx(t)
            P = P * ab
            gr = gr + P * (dyp[:, t, :, None] * Cc[:, t, None, :])
            sd = sd + dt[:, t]
        H.append(hl)
        G.append(gr)
        SD.append(sd)
    # (2) the carries
    h_in, g_in = [], [None] * C
    h = x.new_zeros((B, D, N)) if h0 is None else h0.float()
    for c in range(C):
        h_in.append(h)
        h = torch.exp(A * SD[c][..., None]) * h + H[c]
    g = x.new_zeros((B, D, N))
    for c in reversed(range(C)):
        g_in[c] = g
        g = torch.exp(A * SD[c][..., None]) * g + G[c]
    # (3) each chunk again
    y32, ddt, dx = (x.new_zeros((B, S, D)) for _ in range(3))
    dBc, dCc = x.new_zeros((B, S, N)), x.new_zeros((B, S, N))
    dA_parts = []
    dh0 = None
    for c, (t0, t1) in enumerate(spans):
        h = h_in[c]
        starts = []
        for t in range(t0, t1):
            if (t - t0) % subseg == 0:
                starts.append(h)
            h = step_abar(t) * h + step_bx(t)
        gcar = g_in[c]
        dA_c = x.new_zeros((B, D, N))
        for q in reversed(range(len(starts))):
            u0, u1 = t0 + q * subseg, min(t1, t0 + (q + 1) * subseg)
            hs, abars = [starts[q]], []
            for t in range(u0, u1):
                abars.append(step_abar(t))
                hs.append(abars[-1] * hs[-1] + step_bx(t))
            for t in reversed(range(u0, u1)):
                i = t - u0
                gk = dyp[:, t, :, None] * Cc[:, t, None, :] + gcar
                dlin = gk * hs[i] * abars[i]
                dA_c = dA_c + dlin * dt[:, t, :, None]
                gB = (gk * Bc[:, t, None, :]).sum(-1)
                ddt[:, t] = (dlin * A).sum(-1) + x[:, t] * gB
                dx[:, t] = dt[:, t] * gB
                y32[:, t] = (hs[i + 1] * Cc[:, t, None, :]).sum(-1)
                dBc[:, t] = (gk * (dt[:, t] * x[:, t])[..., None]).sum(1)
                dCc[:, t] = (dyp[:, t, :, None] * hs[i + 1]).sum(1)
                gcar = abars[i] * gk
        dA_parts.append(dA_c)
        if c == 0 and h0 is not None:
            dh0 = gcar
    dA = torch.stack(dA_parts, 1).sum((0, 1))
    # the epilogue
    dsk = rnd(Dskip)
    ypre = rnd(rnd(y32) + rnd(dsk * x))
    sig = rnd(torch.sigmoid(zf))
    dsil = rnd(sig * rnd(1.0 + rnd(zf * rnd(1.0 - sig))))
    dz = rnd(rnd(gy.float() * ypre) * dsil)
    dxin = rnd(rnd(dyp * dsk) + rnd(dx))
    ds = rnd(rnd(ddt) * torch.where(s > 20, torch.ones_like(s),
                                    rnd(torch.sigmoid(s))))
    dproj = torch.zeros(proj.shape, dtype=dtype)
    dproj[..., r:r + N] = dBc.to(dtype)
    dproj[..., r + N:] = dCc.to(dtype)
    return (dxin.to(dtype), ds.to(dtype), rnd(ds.sum((0, 1))), dA * A,
            dproj, rnd(rnd(dyp * x).sum((0, 1))), dz.to(dtype), dh0)


def lru_chunked_bwd(gy, r_pre, i_pre, b_r, b_i, lam, xr, gate, h0=None,
                    chunks=LRU.BWD_CHUNKS, steps=STEPS):
    """The gated entry's gradient as ``lru_bwd_kernel`` computes it: (1)
    the forward's segment-start states by lru_kernel's chunk summaries and
    carry walk; (2) the segments from the last to the first, each chunk's
    summaries from zero in both directions (cumA, local end state, local
    adjoint sum_u cumA_u gh_u), its carry-in by the forward walk from the
    segment's start and its adjoint carry by the backward walk from the
    next segment's, h = cumA * carry + local, then g_t = gh_t + a_{t+1}
    g_{t+1} over its steps. Returns what ``rglru_scan_gated_backward_cuda``
    does."""
    dtype = xr.dtype
    f32 = torch.float32
    rnd = lambda v: v.to(dtype).to(f32)  # noqa: E731
    B, S, W = xr.shape
    x = xr.float()
    r = torch.sigmoid(r_pre + b_r)
    i = torch.sigmoid(i_pre + b_i)
    neg_c = -ref.RGLRU_C * F.softplus(lam)
    log_a = neg_c * r
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    inner = 1.0 - e2
    beta = torch.sqrt(torch.clamp(inner, min=1e-12))
    bx = beta * i * x
    gh = rnd(gy.float() * gate.float())
    seg = chunks * steps
    nseg = -(-S // seg)

    def summaries(s0):
        """Each chunk of the segment at s0 from zero: (cumA_u, local_u)
        for its steps, (cumA, local end, local adjoint) for the walks."""
        out = []
        for j in range(chunks):
            t1 = min(S, s0 + j * steps)
            ts = range(t1, min(S, s0 + (j + 1) * steps))
            ca, lh, G = (x.new_ones((B, W)), x.new_zeros((B, W)),
                         x.new_zeros((B, W)))
            cum, loc = [], []
            for t in ts:
                lh = a[:, t] * lh + bx[:, t]
                ca = a[:, t] * ca
                G = G + ca * gh[:, t]
                cum.append(ca)
                loc.append(lh)
            out.append((list(ts), cum, loc, ca, lh, G))
        return out

    hseg, carry = [], (x.new_zeros((B, W)) if h0 is None else h0.float())
    for k in range(nseg):                       # (1)
        hseg.append(carry)
        for *_, ca, lh, _ in summaries(k * seg):
            carry = ca * carry + lh
    dr, di, dxr, dgate = (x.new_zeros((B, S, W)) for _ in range(4))
    sums = x.new_zeros((3, chunks, B, W))       # dc, db_r, db_i a chunk
    gcarry = x.new_zeros((B, W))
    for k in reversed(range(nseg)):             # (2)
        sm = summaries(k * seg)
        nxt = gcarry
        for *_, ca, _, G in reversed(sm):
            nxt = ca * nxt + G
        for j, (ts, cum, loc, *_) in enumerate(sm):
            cin = hseg[k]
            for ca, lh, _ in (m[3:] for m in sm[:j]):
                cin = ca * cin + lh
            gc = gcarry
            for ca, _, G in (m[3:] for m in reversed(sm[j + 1:])):
                gc = ca * gc + G
            hv = [cu * cin + lo for cu, lo in zip(cum, loc)]
            for u in reversed(range(len(ts))):
                t = ts[u]
                g = gh[:, t] + gc
                hp = hv[u - 1] if u else cin
                gx = g * x[:, t]
                dlog = g * hp * a[:, t] + torch.where(
                    inner[:, t] >= 1e-12,
                    2.0 * (-((gx * i[:, t]) / (2.0 * beta[:, t])) * e2[:, t]),
                    torch.zeros_like(g))
                drp = dlog * neg_c * (1 - r[:, t]) * r[:, t]
                dip = gx * beta[:, t] * (1 - i[:, t]) * i[:, t]
                dr[:, t], di[:, t] = drp, dip
                dxr[:, t] = rnd(g * (beta[:, t] * i[:, t]))
                dgate[:, t] = rnd(gy[:, t].float() * rnd(hv[u]))
                sums[:, j] += torch.stack([dlog * r[:, t], drp, dip])
                gc = a[:, t] * g
        gcarry = nxt
    dc, dbr, dbi = sums.sum(1).sum(1)           # chunks in order, then B
    dlam = dc * -ref.RGLRU_C * torch.where(lam > 20, torch.ones_like(lam),
                                           torch.sigmoid(lam))
    return (dr, di, dbr, dbi, dlam, dxr.to(dtype), dgate.to(dtype),
            gcarry if h0 is not None else None)


# -- inputs and comparisons --------------------------------------------------------
def _fused_np(B, S, D, N, r_, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)  # noqa: E731
    return {"xin": f(B, S, D), "dt_pre": f(B, S, D) * 0.5,
            "dt_bias": np.log(np.expm1(1e-2)) + f(D) * 0.1,
            "A_log": np.log(np.tile(np.arange(1, N + 1.0), (D, 1)))
            + f(D, N) * 0.1,
            "proj": f(B, S, r_ + 2 * N), "Dskip": 1.0 + f(D) * 0.1,
            "z": f(B, S, D), "h0": f(B, D, N) * 0.5, "gy": f(B, S, D)}


def _lru_np(B, S, W, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)  # noqa: E731
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, W)) / 8.0))
    return {"xr": f(B, S, W), "w_r": f(W, W) / np.sqrt(W),
            "w_i": f(W, W) / np.sqrt(W), "b_r": f(W) * 0.1,
            "b_i": f(W) * 0.1, "lam": lam, "gate": f(B, S, W),
            "h0": f(B, W) * 0.5, "gy": f(B, S, W)}


def _t(inp, keys, dtype):
    return [torch.tensor(np.asarray(inp[k], np.float32),
                         dtype=dtype if k in ACTS else torch.float32)
            for k in keys]


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


def _hold(got, want, dtype, fp32_tol, names, loose=()):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == "float32":
            _close(g, w.detach().float().numpy(), fp32_tol)
        else:
            _close_to_scale(g.float(), w.detach().float().numpy(),
                            BF16_DT_TOL if name in loose else 2e-2)


class _ChunkedFn(torch.autograd.Function):
    """A plain forward with one of the decompositions as its backward."""

    @staticmethod
    def forward(ctx, fwd, bwd, *args):
        ctx.bwd = bwd
        ctx.save_for_backward(*args)
        return fwd(*args)

    @staticmethod
    def backward(ctx, gy):
        return (None, None, *ctx.bwd(gy, *ctx.saved_tensors)[:7])


# -- the fused Mamba backward -------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N,r", FUSED_CASES)
def test_mamba_chunked_backward_matches_plain_backward(B, S, D, N, r, dtype,
                                                       with_h0):
    tdt, _ = DTYPES[dtype]
    inp = _fused_np(B, S, D, N, r, seed=S * D + N)
    args = _t(inp, FUSED_KEYS, tdt)
    gy = _t(inp, ("gy",), tdt)[0]
    h0 = _t(inp, ("h0",), torch.float32)[0] if with_h0 else None
    got = mamba_chunked_bwd(gy, *args, h0)
    want = ref.mamba_scan_fused_bwd_ref(gy, *args, h0)
    _hold(got, want, dtype, 1e-4, FUSED_KEYS + ("h0",),
          loose=("dt_pre", "dt_bias"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,D,N,r", FUSED_JAX_CASES)
def test_mamba_chunked_backward_matches_jax_grad(B, S, D, N, r, dtype):
    tdt, jdt = DTYPES[dtype]
    inp = {k: np.asarray(v, np.float32)
           for k, v in _fused_np(B, S, D, N, r, seed=7 * S + D).items()}

    def f(xin, dt_pre, dt_bias, A_log, proj, Dskip, z):
        dt = jax.nn.softplus(dt_pre + dt_bias.astype(jdt)).astype(jnp.float32)
        y = _fused_chunk_scan(dt, proj[..., r:r + N], proj[..., r + N:], xin,
                              -jnp.exp(A_log), 8).astype(jdt)
        return (y + Dskip.astype(jdt) * xin) * jax.nn.silu(z)

    jargs = [jnp.asarray(inp[k]).astype(jdt if k in ACTS else jnp.float32)
             for k in FUSED_KEYS]
    _, vjp = jax.vjp(f, *jargs)
    want = vjp(jnp.asarray(inp["gy"]).astype(jdt))
    ts = [t.requires_grad_() for t in _t(inp, FUSED_KEYS, tdt)]
    y = _ChunkedFn.apply(ref.mamba_scan_fused_ref, mamba_chunked_bwd, *ts)
    y.backward(torch.from_numpy(inp["gy"]).to(tdt))
    for key, t, w in zip(FUSED_KEYS, ts, want, strict=True):
        assert t.grad.dtype == t.dtype
        if dtype == "float32":
            _close(t.grad, np.asarray(w, np.float32), 1e-4)
        else:
            _close_to_scale(t.grad.float(), np.asarray(w, np.float32),
                            BF16_DT_TOL if key in ("dt_pre", "dt_bias")
                            else 2e-2)


# -- the gated RG-LRU backward ------------------------------------------------------
def _lru_inputs(inp, dtype):
    xr, w_r, w_i, gate, gy = _t(inp, ("xr", "w_r", "w_i", "gate", "gy"),
                                dtype)
    xf = xr.float()
    b_r, b_i, lam = _t(inp, ("b_r", "b_i", "lam"), torch.float32)
    return [xf @ w_r, xf @ w_i, b_r, b_i, lam, xr, gate], gy


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", LRU_CASES)
def test_lru_chunked_backward_matches_plain_backward(B, S, W, dtype,
                                                     with_h0):
    tdt, _ = DTYPES[dtype]
    inp = _lru_np(B, S, W, seed=S + 3 * W)
    args, gy = _lru_inputs(inp, tdt)
    h0 = _t(inp, ("h0",), torch.float32)[0] if with_h0 else None
    got = lru_chunked_bwd(gy, *args, h0)
    want = ref.rglru_scan_gated_bwd_ref(gy, *args, h0)
    _hold(got, want, dtype, 1e-5, LRU_KEYS + ("h0",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W", LRU_JAX_CASES)
def test_lru_chunked_backward_matches_jax_grad(B, S, W, dtype):
    tdt, jdt = DTYPES[dtype]
    inp = {k: np.asarray(v, np.float32)
           for k, v in _lru_np(B, S, W, seed=5 * S + W).items()}
    keys = ("xr", "w_r", "w_i", "b_r", "b_i", "lam", "gate")

    def f(xr, w_r, w_i, b_r, b_i, lam, gate):
        a, bx = jgates({"w_r": w_r, "w_i": w_i, "b_r": b_r, "b_i": b_i,
                        "lam": lam}, xr)

        def combine(left, right):
            return left[0] * right[0], left[1] * right[0] + right[1]

        _, h = jax.lax.associative_scan(combine, (a, bx), axis=1)
        return h.astype(jdt) * gate

    jargs = [jnp.asarray(inp[k]).astype(jdt if k in ACTS else jnp.float32)
             for k in keys]
    _, vjp = jax.vjp(f, *jargs)
    want = vjp(jnp.asarray(inp["gy"]).astype(jdt))
    ts = [t.requires_grad_() for t in _t(inp, keys, tdt)]
    xr, w_r, w_i, b_r, b_i, lam, gate = ts
    xf = xr.float()
    y = _ChunkedFn.apply(ref.rglru_scan_gated_ref, lru_chunked_bwd,
                         xf @ w_r, xf @ w_i, b_r, b_i, lam, xr, gate)
    y.backward(torch.from_numpy(inp["gy"]).to(tdt))
    for t, w in zip(ts, want, strict=True):
        assert t.grad.dtype == t.dtype
        if dtype == "float32":
            _close(t.grad, np.asarray(w, np.float32), 1e-5)
        else:
            _close_to_scale(t.grad.float(), np.asarray(w, np.float32), 2e-2)


def test_lru_forward_walk_gives_the_states_at_segment_starts():
    """Pass (1)'s carries are the forward's states before each segment."""
    B, S, W = 2, 2 * SEG + 5, 7
    inp = _lru_np(B, S, W, seed=11)
    (r_pre, i_pre, b_r, b_i, lam, xr, _), _ = _lru_inputs(inp, torch.float32)
    h0 = _t(inp, ("h0",), torch.float32)[0]
    r = torch.sigmoid(r_pre + b_r)
    i = torch.sigmoid(i_pre + b_i)
    log_a = -ref.RGLRU_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * xr.float()
    h = ref.lru_scan_ref(a, bx, h0)
    carry = h0
    for k in range(-(-S // SEG)):
        want = h0 if k == 0 else h[:, k * SEG - 1]
        torch.testing.assert_close(carry, want, rtol=1e-6, atol=1e-6)
        for j in range(LRU.BWD_CHUNKS):
            ca, lh = torch.ones_like(carry), torch.zeros_like(carry)
            for t in range(k * SEG + j * STEPS,
                           min(S, k * SEG + (j + 1) * STEPS)):
                lh = a[:, t] * lh + bx[:, t]
                ca = a[:, t] * ca
            carry = ca * carry + lh


# -- the wrappers' scratch -----------------------------------------------------------
@pytest.mark.parametrize("B,S,D,N", [(2, 2048, 8192, 16), (1, 1, 12, 4),
                                     (3, 65, 130, 32), (2, 129, 257, 8)])
def test_fused_backward_scratch_sizes(B, S, D, N):
    C = math.ceil(S / T)
    G = 64 if N == 32 else 128
    assert MS.fused_bwd_channels(N) == G
    got = MS.fused_bwd_scratch(B, S, D, N)
    assert got == {"sums": B * C * D * (2 * N + 1),
                   "part": B * S * math.ceil(D / G) * 2 * N,
                   "dApart": B * C * D * N, "chan": 2 * B * C * D,
                   "planes": 2 * B * S * D}
    # fp32: the two planes' value pairs take 8 bytes an entry, not 4
    assert MS.fused_bwd_scratch(B, S, D, N, 4)["planes"] == 4 * B * S * D
    if (B, S, D, N) == (2, 2048, 8192, 16):
        # the blocks' dBc | dCc partials: 1/8 of the 16-channel blocks'
        assert got["part"] * 8 == B * S * (D // 16) * 2 * N


@pytest.mark.parametrize("B,S,W", [(2, 2048, 2560), (1, 1, 5),
                                   (3, 129, 50)])
def test_lru_backward_scratch_sizes(B, S, W):
    assert LRU.BWD_SEGMENT == LRU.BWD_CHUNKS * LRU.BWD_STEPS == 128
    got = LRU.backward_scratch(B, S, W)
    assert got == {"hseg": B * math.ceil(S / 128) * W, "part": 3 * B * W}
    if (B, S, W) == (2, 2048, 2560):
        assert got["hseg"] * 4 == 327_680          # 0.33 MB
