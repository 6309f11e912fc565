"""The port's attention oracle and its CPU ``ops.flash_attention`` against
the reference's Pallas kernel (interpret mode) and its oracle, on the same
NumPy inputs.

Tolerances are those of ``tests/test_kernels.py``: 5e-6 in float32 (the
same math in another summation order), 2e-2 in bfloat16 (the output is
rounded to bf16 on both sides). The CUDA kernel itself is held against the
same oracle on the card, in ``tests/test_torch_cuda_kernels.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_bhsd  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

SWEEP = [   # tests/test_kernels.py::test_flash_attention_sweep
    (1, 2, 2, 64, 64, 32, True, 0, 16, 16),     # MHA causal
    (2, 4, 2, 128, 128, 64, True, 0, 32, 64),   # GQA, uneven blocks
    (1, 4, 1, 64, 64, 32, True, 0, 64, 16),     # MQA
    (1, 2, 2, 64, 64, 32, True, 16, 16, 16),    # sliding window
    (1, 2, 2, 96, 96, 16, True, 24, 32, 32),    # window > block
    (2, 2, 2, 64, 64, 32, False, 0, 32, 32),    # bidirectional
]
DTYPES = [("float32", 5e-6), ("bfloat16", 2e-2)]


def _inputs(B, H, K, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd)).astype(np.float32),
            rng.standard_normal((B, K, Sk, hd)).astype(np.float32),
            rng.standard_normal((B, K, Sk, hd)).astype(np.float32))


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,window,bq,bk", SWEEP)
def test_oracle_matches_pallas_kernel_and_reference_oracle(
        B, H, K, Sq, Sk, hd, causal, window, bq, bk, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, K, Sq, Sk, hd, Sq + hd),
                                       dtype)
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, hd)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window),
           tol)
    _close(got, flash_attention_bhsd(jq, jk, jv, causal=causal, window=window,
                                     block_q=bq, block_k=bk, interpret=True),
           tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("Sk", [1, 7, 33])
def test_decode_shapes_match_reference_oracle(Sk, dtype, tol):
    # Sq = 1 against any Sk: the shapes the Pallas kernel's block assert
    # refuses, so the reference oracle alone is the yardstick.
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 6, 2, 1, Sk, 32, Sk), dtype)
    _close(ref.attention_ref(tq, tk, tv), jref.attention_ref(jq, jk, jv), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_ops_entry_in_bshd_layout_matches_reference_ops(causal, window,
                                                         dtype, tol):
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((2, S, h, 16)).astype(np.float32)
              for S, h in ((9, 4), (9, 2), (9, 2))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (2, 9, 4, 16) and got.dtype == tq.dtype
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                     use_pallas=False), tol)


def test_ops_refuses_a_window_without_causal_mask():
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(q, q, q, causal=False, window=2)


def test_kernel_modules_build_nothing_at_import(tmp_path):
    # Importing the kernel modules (as the CPU tests and every worker do)
    # must not look for nvcc or write a library: the build is at first launch.
    build = tmp_path / "build"
    code = ("import repro_torch.kernels.flash_attention as FA, "
            "repro_torch.kernels.reassemble as R, repro_torch.kernels.ops\n"
            "assert FA.LAUNCHES == {'flash_attention': 0, "
            "'flash_attention_train': 0, 'flash_attention_backward': 0}\n"
            "assert FA.SOURCE.exists() and FA.SOURCE_BWD.exists() "
            "and R.SOURCE.exists()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_BUILD_DIR=str(build), PATH="/nonexistent",
               CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not build.exists()


# -- the split-key decode path: its plain version against the oracles ------

SPLIT_SKS = [1, 63, 64, 65, 144, 2047, 2048]   # around the 32-key spans
SPLIT_HEADS = [(6, 2, 128), (4, 1, 256)]        # (H, K, hd): GQA, MQA


def _split_vs_oracles(B, H, K, Sq, Sk, hd, causal, window, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, K, Sq, Sk, hd,
                                               Sk + hd + Sq), dtype)
    got = ref.attention_split_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, hd)
    _close(got, flash_attention_bhsd(jq, jk, jv, causal=causal, window=window,
                                     block_q=Sq, block_k=Sk, interpret=True),
           tol)
    # attention_ref averages a row with no kept key over the fill; the
    # split path gives 0 there, as the Pallas kernel does.
    iq = np.arange(Sq)[:, None] + Sk - Sq
    j = np.arange(Sk)[None, :]
    kept = np.ones((Sq, Sk), bool)
    if causal:
        kept &= j <= iq
    if window > 0:
        kept &= iq - j < window
    live = kept.any(axis=1)
    assert not got[:, :, ~live].float().any()
    _close(got[:, :, live],
           ref.attention_ref(tq, tk, tv, causal=causal,
                             window=window)[:, :, live].float(), tol)
    return got


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("H,K,hd", SPLIT_HEADS)
@pytest.mark.parametrize("Sk", SPLIT_SKS)
def test_split_decode_matches_pallas_kernel_and_oracle(Sk, H, K, hd, dtype,
                                                       tol):
    _split_vs_oracles(1, H, K, 1, Sk, hd, True, 0, dtype, tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,window,launched", [
    (1, 6, 2, 1, 2048, 128, True, 100, (60, 64)),   # a window drops 60 splits
    (2, 4, 1, 3, 300, 128, True, 70, (7, 10)),      # 3 positions x 4 heads
    (1, 4, 1, 1, 2048, 256, True, 32, (63, 64)),    # one split left
    (1, 4, 1, 1, 2048, 256, True, 33, (62, 64)),    # one key past it
    (1, 2, 1, 4, 2, 128, True, 0, (0, 1)),          # rows 0-1 keep no key
    (1, 2, 2, 2, 70, 32, False, 0, (0, 1)),         # bidirectional, one span
    (1, 8, 1, 2, 1000, 64, True, 0, (0, 16)),       # 64-key spans at hd 64
])
def test_split_decode_windows_masked_rows_and_spans(B, H, K, Sq, Sk, hd,
                                                    causal, window, launched,
                                                    dtype, tol):
    plan = FA.launch_plan((B, H, Sq, hd), (B, K, Sk, hd), getattr(torch, dtype),
                          window=window)
    assert plan["path"] == "decode"
    assert (plan["first"], plan["last"]) == launched
    _split_vs_oracles(B, H, K, Sq, Sk, hd, causal, window, dtype, tol)


@pytest.mark.parametrize("Sk,hd", [(1, 128), (144, 128), (2048, 256),
                                   (5000, 64), (100000, 16)])
def test_split_plan_depends_on_keys_and_head_dim_only(Sk, hd):
    plans = []
    for B, H, K in [(1, 24, 8), (4, 24, 8), (1, 10, 1), (8, 10, 1),
                    (3, 32, 32), (2, 16, 1)]:
        p = FA.launch_plan((B, H, 1, hd), (B, K, Sk, hd), torch.bfloat16)
        assert p["path"] == "decode"
        plans.append((p["span"], p["splits"], p["first"], p["last"]))
    assert len(set(plans)) == 1
    span, splits, first, last = plans[0]
    assert (span, splits) == FA.split_plan(Sk, hd)
    assert span % FA.SPLIT_TILE == 0 and span * hd >= 4096
    assert 1 <= splits <= FA.MAX_SPLITS and (splits - 1) * span < max(Sk, 1)
    assert (first, last) == (0, splits)
    if (Sk, hd) == (2048, 256):          # a full recurrentgemma ring
        assert 32 <= splits <= 64


@pytest.mark.parametrize("Sq,G,dtype,want", [
    (1, 3, "bfloat16", "decode"), (1, 64, "float32", "decode"),
    (5, 3, "bfloat16", "decode"), (6, 3, "bfloat16", "tensor_core"),
    (2, 10, "float32", "cuda_core"), (2048, 10, "bfloat16", "tensor_core"),
])
def test_launcher_path_follows_shapes_and_dtype(Sq, G, dtype, want):
    assert FA.path(Sq, G, getattr(torch, dtype)) == want
