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
            "assert FA.LAUNCHES == {'flash_attention': 0}\n"
            "assert FA.SOURCE.exists() and R.SOURCE.exists()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_BUILD_DIR=str(build), PATH="/nonexistent",
               CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert not build.exists()
