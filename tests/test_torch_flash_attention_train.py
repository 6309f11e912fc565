"""Training causal attention through ``ops.flash_attention_train``: its
plain versions (the CPU side of ``FA.FlashAttentionTrainFn``) against
autograd of the port's ``models/attention.py`` ``_sdpa`` and against
``jax.vjp`` of the reference's ``repro/models/attention.py`` ``_sdpa``,
which the reference trains through; the stored JAX result that the card
tests hold the kernels to (``tests/attention_fixture.py``); the per-row
rule that holds the output; how the backward splits its key tiles; and the
routing of ``attention_train``, which takes the kernels only for plain
CUDA tensors in bf16 with autograd recording. The kernels themselves are
held against the plain versions and the stored JAX result on the card, in
``tests/test_torch_cuda_kernels.py``.

The plain versions compute in fp32 as ``_sdpa`` does, in another order
(the backward from the log-sum-exp and D = rowsum(dO * O) where autograd
differentiates the softmax), so the two agree to fp32 rounding: 1e-5 on
the output and the log-sum-exp, 1e-4 of each gradient's largest
magnitude (or of 1, where it is smaller). In bfloat16 the reference
rounds its scores and probabilities to bf16 (the plain versions keep them
fp32): 2^-5 of each output row's largest magnitude (four bf16 steps) and
2e-2 of each gradient's, the scans' bf16 rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

import attention_fixture  # noqa: E402
from repro.models.attention import _sdpa as jsdpa  # noqa: E402
from repro.models.attention import causal_window_mask as jmask  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

ROW_TOL = 2.0 ** -5      # the output, per row: four bf16 steps of its largest


def _qkv(B, S, H, K, hd, dtype=torch.float32, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    mk = lambda h: torch.randn(B, S, h, hd, generator=g).to(device, dtype)  # noqa: E731
    return mk(H), mk(K), mk(K)


def _rel(got, want):
    """The largest error over the larger of 1 and the largest magnitude
    (at S = 1 the gradients of q and k vanish: their error is round-off)."""
    return ((got - want).abs().max() / max(want.abs().max().item(), 1.0)).item()


@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("window", [0, 7])
def test_plain_versions_match_autograd_of_sdpa(window, G, hd, S):
    K = 2
    q, k, v = (t.requires_grad_() for t in _qkv(2, S, G * K, K, hd,
                                                  seed=S + hd + G))
    mask = A.causal_window_mask(S, S, window)
    want = A._sdpa(q, k, v, mask=mask)
    before = dict(FA.LAUNCHES)
    got = ops.flash_attention_train(q, k, v, window=window)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)

    # The log-sum-exp the backward reads: over the kept scaled scores.
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    _, lse = ref.attention_train_ref(qt, kt, vt, window=window)
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     qt.reshape(2, K, G, S, hd), kt) * hd ** -0.5
    s = s.masked_fill(~mask[0], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(2, -1, S),
                               atol=1e-5, rtol=1e-5)

    gout = torch.randn_like(want)
    grads = torch.autograd.grad(got, (q, k, v), gout)
    wants = torch.autograd.grad(want, (q, k, v), gout)
    for name, a, b in zip("qkv", grads, wants):
        assert _rel(a, b) < 1e-4, name
    assert FA.LAUNCHES == before


def _vjp_of_reference(x, window, jdt):
    """out, dq, dk, dv of the reference's ``_sdpa`` under its causal (and
    window) mask, by ``jax.vjp`` at ``jdt``, as float32 NumPy."""
    mask = jmask(x["q"].shape[1], x["q"].shape[1], window)
    out, vjp = jax.vjp(lambda q, k, v: jsdpa(q, k, v, mask=mask),
                       *(jnp.asarray(x[n]).astype(jdt) for n in "qkv"))
    return [np.asarray(t.astype(jnp.float32))
            for t in (out, *vjp(jnp.asarray(x["dout"]).astype(jdt)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 37])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("window", [0, 7])
def test_matches_jax_vjp_of_reference_sdpa(window, G, hd, S, dtype):
    """The same NumPy q, k, v and dO through ``ops.flash_attention_train``
    (with autograd) and through ``jax.vjp`` of the reference's ``_sdpa``."""
    B, K = 2, 2
    r = np.random.default_rng(S + hd + G + window)
    x = {n: r.standard_normal((B, S, h, hd)).astype(np.float32)
         for n, h in (("q", G * K), ("k", K), ("v", K), ("dout", G * K))}
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(x[n]).to(tdt).requires_grad_() for n in "qkv")
    out = ops.flash_attention_train(q, k, v, window=window)
    grads = torch.autograd.grad(out, (q, k, v), torch.tensor(x["dout"]).to(tdt))
    want = _vjp_of_reference(x, window, getattr(jnp, dtype))
    fp32 = dtype == "float32"
    assert out.dtype == tdt
    assert ref.row_relative_error(out.detach(), torch.tensor(want[0])) < (
        1e-5 if fp32 else ROW_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want[1:]):
        assert _rel(a.float(), torch.tensor(b)) < (1e-4 if fp32 else 2e-2), name


def test_stored_jax_result_is_what_jax_gives():
    """``tests/data/flash_attention_train_jax.npz``, which the card tests
    read, holds ``jax.vjp`` of the reference's ``_sdpa`` on the fixture's
    inputs (to its float16 storage), and the port's plain versions on the
    CPU give it too."""
    x = attention_fixture.inputs()
    stored = attention_fixture.load()
    fresh = attention_fixture.jax_result(x)
    q, k, v = (torch.tensor(x[n]).requires_grad_() for n in "qkv")
    out = ops.flash_attention_train(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.tensor(x["dout"]))
    for name, mine in zip(("out", "dq", "dk", "dv"), (out.detach(), *grads)):
        top = np.abs(fresh[name]).max()
        assert np.abs(stored[name] - fresh[name]).max() <= 2.0 ** -10 * top, name
        assert _rel(mine, torch.tensor(fresh[name])) < 1e-5, name


def _emulated_kernel_output(q, k, v, lse, fault=None):
    """The training forward as the kernel rounds it (P to bf16 as the PV
    operand, the output to bf16), from the plain lse, with a planted
    fault: the wrong kv head's values, one 64-key tile dropped from PV
    for the later rows, one 64-row tile of the output from another head."""
    B, H, S, hd = q.shape
    K = k.shape[1]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.reshape(B, K, H // K, S, hd).float(),
                     k.float()) * hd ** -0.5
    s = s.masked_fill(~ref._train_mask(S, S, 0, q.device), float("-inf"))
    p = torch.exp(s - lse.reshape(B, K, H // K, S, 1)).to(torch.bfloat16).float()
    if fault == "key_tile":
        p[..., S // 2:, 64:128] = 0
    vv = v.flip(1) if fault == "kv_head" else v
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vv.float()).reshape(B, H, S, hd)
    out = out.to(torch.bfloat16)
    if fault == "row_tile":
        out[:, 0, S - 64:] = out[:, 1, S - 64:]
    return out


@pytest.mark.parametrize("fault,fails", [(None, False), ("kv_head", True),
                                         ("key_tile", True),
                                         ("row_tile", True)])
def test_output_rule_takes_the_kernels_rounding_and_no_planted_fault(
        fault, fails):
    """The rule the card tests and ``chip_smoke.py`` hold the training
    forward's output to, 2^-5 of each row's largest magnitude, at
    phi4-mini's S and head size: the kernel's own rounding (1 bf16 step
    here) passes; a wrong kv head, a dropped key tile or a tile of rows
    from another head, each with the log-sum-exp right, fails."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, h, 2048, 128, generator=g).to(torch.bfloat16)
               for h in (4, 2, 2))
    want, lse = ref.attention_train_ref(q, k, v)
    err = ref.row_relative_error(_emulated_kernel_output(q, k, v, lse, fault),
                                 want)
    assert (err > ROW_TOL) == fails, err


@pytest.mark.parametrize("B,K,S,H,hd,sms,splits", [
    (2, 8, 2048, 24, 128, 132, 1),      # phi4-mini's microbatch: 512 blocks
    (1, 1, 2048, 10, 256, 132, 5),      # recurrentgemma's local layers, B=1
    (1, 1, 2048, 10, 256, 16, 1),       # a card their 64 blocks fill
    (1, 1, 64, 10, 256, 132, 3),        # 640 rows: 256 a part at least
    (2, 2, 37, 6, 64, 132, 1),          # 111 rows
    (1, 1, 1024, 8, 128, 132, 8),       # 16 blocks: capped
    (1, 4, 0, 4, 128, 132, 1),          # no keys
])
def test_backward_splits_key_tiles_only_where_they_leave_sms_idle(
        B, K, S, H, hd, sms, splits):
    assert FA.dkv_splits(B, K, S, S, H, hd, sms) == splits


@pytest.mark.parametrize("case", ["cpu", "meta", "softcap", "fp32",
                                  "no_grad", "head_dim"])
def test_attention_train_keeps_sdpa_off_the_kernels_domain(case, monkeypatch):
    """Each call keeps ``_sdpa``: CPU or meta tensors (bf16, autograd on,
    what the card would train through the kernels), a softcap, fp32,
    no-grad, a head size the kernels do not take; no launch is counted."""
    B, S, d, H, K = 1, 8, 32, 4, 2
    hd = 96 if case == "head_dim" else 64
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    device = "meta" if case == "meta" else "cpu"
    g = torch.Generator().manual_seed(1)
    mk = lambda *shape: torch.randn(*shape, generator=g).to(device)  # noqa: E731
    params = {"wq": mk(d, H, hd), "wk": mk(d, K, hd), "wv": mk(d, K, hd),
              "wo": mk(H, hd, d)}
    x = mk(B, S, d).to(dtype).requires_grad_()
    calls = []
    sdpa = A._sdpa
    monkeypatch.setattr(A, "_sdpa",
                        lambda *a, **kw: calls.append(1) or sdpa(*a, **kw))
    monkeypatch.setattr(ops, "flash_attention_train", None)   # never called
    FA.reset_launch_counts()
    kw = dict(dtype=dtype, eps=1e-6, causal=True, use_rope=False,
              softcap=30.0 if case == "softcap" else 0.0)
    if case == "no_grad":
        with torch.no_grad():
            out = A.attention_train(params, x, None, None, **kw)
    else:
        out = A.attention_train(params, x, None, None, **kw)
    assert out.shape == (B, S, d)
    assert calls == [1]
    assert FA.LAUNCHES == {name: 0 for name in FA.LAUNCHES}


def test_function_calls_the_cuda_entries_through_module_globals(monkeypatch):
    """A wrapper put in the module's globals (as the benchmark's profiler
    ranges are) sees the forward, an activation checkpoint's recompute and
    the backward: the CUDA entries stood in for by the plain versions."""
    calls = []

    def fwd(qt, kt, vt, *, window):
        calls.append("fwd")
        return ref.attention_train_ref(qt, kt, vt, window=window)

    def bwd(*args, window):
        calls.append("bwd")
        return ref.attention_train_bwd_ref(*args, window=window)

    monkeypatch.setattr(FA, "flash_attention_train_cuda", fwd)
    monkeypatch.setattr(FA, "flash_attention_backward_cuda", bwd)
    q, k, v = (t.requires_grad_() for t in _qkv(1, 9, 6, 2, 64))
    out = checkpoint(lambda a, b, c: FA.FlashAttentionTrainFn.apply(
        True, a, b, c, 0), q, k, v, use_reentrant=False)
    out.sum().backward()
    assert calls == ["fwd", "fwd", "bwd"]
    want = torch.autograd.grad(
        A._sdpa(q, k, v, mask=A.causal_window_mask(9, 9, 0)).sum(), q)[0]
    assert _rel(q.grad, want) < 1e-4


def test_a_row_that_keeps_no_key_gives_zeros():
    """End-aligned rows past the keys (Sq > Sk): output 0, lse +inf and no
    gradient, as the kernel gives them."""
    qt, kt, vt = (t.transpose(1, 2) for t in _qkv(1, 5, 2, 1, 64))
    kt, vt = kt[:, :, :3], vt[:, :, :3]
    out, lse = ref.attention_train_ref(qt, kt, vt)
    assert not out[:, :, :2].any() and torch.isinf(lse[:, :, :2]).all()
    assert torch.isfinite(lse[:, :, 2:]).all()
    dq, dk, dv = ref.attention_train_bwd_ref(torch.ones_like(qt), qt, kt, vt,
                                             out, lse)
    assert not dq[:, :, :2].any()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
