"""The literal scan backward's cluster decomposition, on the CPU.

``scan_bwd_cluster_kernel`` (``csrc/mamba_scan_bwd.cu``, the gradient of
``ops.mamba_scan``) runs one thread-block cluster a batch row and group of
states: rank k of the cluster holds chunk k of the sequence in shared
memory, four threads a state each walk a sub-chunk of it, the sub-chunks'
and then the chunks' (product, local end state, local adjoint) are folded
in order into each chunk's and sub-chunk's carries, and each sub-chunk is
walked forward from its state carry and backward from its adjoint carry.
Where the chunks do not fit, windows of ``cluster`` chunks are swept
forward for their carry-in states, then finished from the last to the
first. No card and no kernel here: the decomposition is written plainly
below at the constants ``mamba_scan.scan_bwd_plan`` returns, and held

* against the plain backward ``ref.ssm_scan_bwd_ref`` with and without h0,
  at S = 1, a chunk less one, a chunk, a chunk and one, one full window and
  two and three windows with a ragged tail (a small shared-memory budget
  passed to the plan makes windows at small D), D not a multiple of a
  block's states, sub-chunks of several steps and a ragged last one at
  the default budget;
* against ``jax.grad`` of the reference's ``_chunked_scan`` read out with
  C, for three of those shapes;

at 1e-4 elementwise in float32 (the tolerance of
``tests/test_torch_scan_backward.py``). The plan itself is held at the
train shape (one window, 16 bytes a state element, no
(B, S, D, N) scratch) and at long S.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import _chunked_scan  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# A budget of 5,200 bytes a block: at N = 4 two buffers of 32 states hold 4
# steps (5,136 bytes with the block's other arrays, 5,648 at 5 steps), so a
# window is 16 * 4 = 64 steps.
SMALL = 5200
WINDOW = MS.SCAN_BWD_CLUSTER * 4
# (B, S, D, N): S = 1; 16 chunks of 3 steps less one, exactly, and one more
# (then 16 of 4, the last 1); one full window; two windows, the second
# ragged; three windows; D * N not a multiple of a block's states (at N =
# 32 a block of 32 states is one channel).
CASES = [(2, 1, 11, 4), (1, 47, 11, 4), (2, 48, 11, 4), (1, 49, 11, 4),
         (2, WINDOW, 11, 4), (2, WINDOW + 36, 11, 4), (1, 150, 11, 4),
         (2, 70, 45, 1), (1, 40, 3, 32), (2, 33, 7, 8)]
JAX_CASES = [CASES[0], CASES[3], CASES[5]]
# At the default budget: chunks of 10 and 3 steps, sub-chunks of 3 (the last
# of one step) and of 1 (the last empty).
DEFAULT_CASES = [(1, 150, 5, 16), (2, 37, 7, 8)]


def cluster_bwd(gy, Abar, Bx, C, h0=None, plan=None):
    """The literal backward as the cluster kernel computes it, at ``plan``
    (``scan_bwd_plan``). Rank k of a cluster owns chunk k of ``chunk`` steps
    of a window of ``cluster`` chunks, its SCAN_BWD_SPLIT threads a state
    one sub-chunk each. (1) Each sub-chunk from zero: the product P of its
    Abar, its local end state e and its local adjoint r = sum_t (prod_{s <=
    t} Abar_s) gy_t C_t, folded in order into the chunk's (P, e, r); a
    forward sweep over the windows folds each window's chunks (h <- P h +
    e) into the next window's carry-in. Then, from the last window to the
    first, each chunk's state carry (its predecessors folded in rank order
    from the window's state) and adjoint carry (its successors folded in
    reverse from the window's adjoint carry, q <- P q + r), each sub-chunk's
    from its chunk's the same way, (2) the states from the state carry, (3)
    g_t = gy_t C_t + q walked backward with q <- Abar_t g_t, and each
    group's sums over its channels of gy_t h_t, then the groups' sums in
    order. Returns what ``mamba_scan_backward_cuda`` does."""
    B, S, D, N = Abar.shape
    K, L, G, W = (plan[k] for k in ("cluster", "chunk", "states", "windows"))
    M = plan["threads"] // G
    assert K * L * W >= S and G % 32 == 0 and G % N == 0
    span, sub = K * L, -(-L // M)
    u = gy[..., None] * C[:, :, None, :]                  # (B, S, D, N)
    zeros = Abar.new_zeros((B, D, N))

    def spans(w, k):        # the sub-chunks of chunk k of window w
        t0 = w * span + k * L
        return [(min(S, t0 + i * sub), min(S, t0 + (i + 1) * sub, t0 + L))
                for i in range(M)]

    def local(t0, t1, with_u):
        p, e, r = Abar.new_ones((B, D, N)), zeros, zeros
        for t in range(t0, t1):
            e = Abar[:, t] * e + Bx[:, t]
            p = p * Abar[:, t]
            if with_u:
                r = r + p * u[:, t]
        return p, e, r

    def fold(parts):        # sub-chunks' (P, e, r) into the chunk's
        p, e, r = Abar.new_ones((B, D, N)), zeros, zeros
        for pi, ei, _ in parts:
            e = pi * e + ei
            p = p * pi
        for pi, _, ri in reversed(parts):
            r = pi * r + ri
        return p, e, r

    hw = [zeros if h0 is None else h0]                    # window carry-ins
    for w in range(W - 1):
        hc = hw[-1]
        for k in range(K):
            p, e, _ = fold([local(*sp, False) for sp in spans(w, k)])
            hc = p * hc + e
        hw.append(hc)
    dA, dBx, h = (torch.empty_like(Abar) for _ in range(3))
    qc = zeros
    for w in reversed(range(W)):
        subs = [[local(*sp, True) for sp in spans(w, k)] for k in range(K)]
        aggs = [fold(s_) for s_ in subs]
        for k in range(K):
            hin, qin = hw[w], qc
            for p, e, _ in aggs[:k]:
                hin = p * hin + e
            for p, _, r in reversed(aggs[k + 1:]):
                qin = p * qin + r
            for i, (t0, t1) in enumerate(spans(w, k)):
                hs, qs = hin, qin
                for p, e, _ in subs[k][:i]:
                    hs = p * hs + e
                for p, _, r in reversed(subs[k][i + 1:]):
                    qs = p * qs + r
                hb = hs
                for t in range(t0, t1):                   # (2)
                    hs = Abar[:, t] * hs + Bx[:, t]
                    h[:, t] = hs
                for t in reversed(range(t0, t1)):         # (3)
                    g = u[:, t] + qs
                    dBx[:, t] = g
                    dA[:, t] = g * (h[:, t - 1] if t > t0 else hb)
                    qs = Abar[:, t] * g
        for p, _, r in reversed(aggs):
            qc = p * qc + r
    groups = plan["groups"]
    pad = groups * (G // N) - D
    terms = torch.nn.functional.pad(gy[..., None] * h, (0, 0, 0, pad))
    part = terms.reshape(B, S, groups, G // N, N).sum(3)  # a group's channels
    dC = part.sum(2)                                      # groups in order
    return dA, dBx, dC, (qc if h0 is not None else None)


def _inputs(B, S, D, N, seed):
    rng = np.random.default_rng(seed)
    return {"Abar": 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D, N)))),
            "Bx": rng.standard_normal((B, S, D, N)) * 0.1,
            "C": rng.standard_normal((B, S, N)),
            "h0": rng.standard_normal((B, D, N)) * 0.5,
            "gy": rng.standard_normal((B, S, D))}


def _t(inp, key):
    return torch.from_numpy(np.asarray(inp[key], np.float32))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,N", CASES)
def test_cluster_backward_matches_plain_backward(B, S, D, N, with_h0):
    plan = MS.scan_bwd_plan(B, S, D, N, smem=SMALL)
    assert plan["cluster"] * plan["chunk"] * plan["windows"] >= S
    inp = _inputs(B, S, D, N, seed=S * D + N)
    args = [_t(inp, k) for k in ("gy", "Abar", "Bx", "C")]
    h0 = _t(inp, "h0") if with_h0 else None
    got = cluster_bwd(*args, h0, plan=plan)
    want = ref.ssm_scan_bwd_ref(*args, h0)
    for g, w in zip(got, want, strict=True):
        if w is None:
            assert g is None
        else:
            assert g.shape == w.shape and g.dtype == w.dtype
            _close(g, w)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,D,N", DEFAULT_CASES)
def test_cluster_backward_at_the_default_plan(B, S, D, N, with_h0):
    plan = MS.scan_bwd_plan(B, S, D, N)
    assert plan["windows"] == 1 and plan["threads"] == 4 * plan["states"]
    inp = _inputs(B, S, D, N, seed=S + D)
    args = [_t(inp, k) for k in ("gy", "Abar", "Bx", "C")]
    h0 = _t(inp, "h0") if with_h0 else None
    got = cluster_bwd(*args, h0, plan=plan)
    for g, w in zip(got, ref.ssm_scan_bwd_ref(*args, h0), strict=True):
        if w is None:
            assert g is None
        else:
            _close(g, w)


def test_cases_cover_the_chunk_and_window_edges():
    plans = {c: MS.scan_bwd_plan(*c, smem=SMALL) for c in CASES}
    w = lambda c: plans[c]["windows"]  # noqa: E731
    K = MS.SCAN_BWD_CLUSTER
    assert [plans[c]["chunk"] for c in CASES[1:4]] == [3, 3, 4]
    assert [c[1] % K for c in CASES[1:4]] == [K - 1, 0, 1]
    assert w(CASES[4]) == 1 and plans[CASES[4]]["chunk"] * K == WINDOW
    assert w(CASES[5]) == 2 and CASES[5][1] % WINDOW != 0
    assert w(CASES[6]) == 3
    for c in CASES:
        B, S, D, N = c
        G = plans[c]["states"]
        assert plans[c]["groups"] == -(-(D * N) // G), c
        # The last group ragged, but at N = 32 (one channel a group).
        assert (D * N) % G != 0 or G == N, c
    assert sum(plans[c]["groups"] > 1 for c in CASES) >= 6


@pytest.mark.parametrize("B,S,D,N", JAX_CASES)
def test_cluster_backward_matches_jax_grad(B, S, D, N):
    inp = {k: np.asarray(v, np.float32)
           for k, v in _inputs(B, S, D, N, seed=3 * S + D).items()}

    def f(A, Bx, C, h0):
        h, _ = _chunked_scan(A, Bx, 8, h0)
        return jnp.einsum("bsin,bsn->bsi", h, C)

    _, vjp = jax.vjp(f, *(jnp.asarray(inp[k]) for k in ("Abar", "Bx", "C",
                                                       "h0")))
    want = vjp(jnp.asarray(inp["gy"]))
    plan = MS.scan_bwd_plan(B, S, D, N, smem=SMALL)
    got = cluster_bwd(*(_t(inp, k) for k in ("gy", "Abar", "Bx", "C",
                                             "h0")), plan=plan)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


def test_plan_at_the_train_shape_takes_one_window_and_16_bytes():
    B, S, D, N = 2, 2048, 8192, 16
    p = MS.scan_bwd_plan(B, S, D, N)
    assert p["windows"] == 1 and p["elem_bytes"] == 16
    assert p["cluster"] == 16 and p["chunk"] * p["cluster"] == S
    assert p["states"] % 32 == 0 and p["states"] % N == 0
    assert p["threads"] == MS.SCAN_BWD_SPLIT * p["states"] <= 1024
    assert p["smem"] <= 227 * 1024                 # a block's most
    assert p["groups"] == -(-(D * N) // p["states"])
    # No (B, S, D, N) scratch: the groups' dC partials and no carry.
    elems = B * S * D * N
    assert p["scratch"] == {"part": B * p["groups"] * S * N, "carry": 0}
    assert p["scratch"]["part"] * 4 < elems
    # gy, C, part, dC, h0 and dh0 beside the 16 bytes: under 2.5 a state
    # element at G = 96 (part 4/6 of a byte written and as much read).
    assert p["side_bytes"] < 2.5 * elems
    assert (p["states"], p["chunk"], p["smem"]) == (96, 128, 228880)


@pytest.mark.parametrize("N", MS.STATE_SIZES)
def test_plan_walks_windows_past_a_clusters_shared_memory(N):
    K = MS.SCAN_BWD_CLUSTER
    one = MS.scan_bwd_plan(1, 2048, 64, N)
    assert one["windows"] == 1 and one["elem_bytes"] == 16
    lmax = max(L for L in range(1, MS.SCAN_BWD_MAX_CHUNK + 1)
               if MS._scan_bwd_smem(32, L, N) <= MS.SCAN_BWD_SMEM)
    assert lmax == MS.SCAN_BWD_MAX_CHUNK      # one TMA box of rows
    edge = MS.scan_bwd_plan(1, K * lmax, 5, N)
    assert (edge["windows"], edge["states"], edge["chunk"]) == (1, 32, lmax)
    for S in (K * lmax + 1, 3 * K * lmax + 7, 100_000):
        p = MS.scan_bwd_plan(2, S, 5, N)
        assert p["windows"] == -(-S // (K * lmax)) > 1
        assert p["chunk"] * K * p["windows"] >= S
        assert p["chunk"] * K * (p["windows"] - 1) < S
        assert p["smem"] <= MS.SCAN_BWD_SMEM and p["elem_bytes"] == 24
        assert p["scratch"]["carry"] == 2 * p["windows"] * 5 * N
    with pytest.raises(ValueError):
        MS.scan_bwd_plan(1, 10, 5, N, smem=400)
