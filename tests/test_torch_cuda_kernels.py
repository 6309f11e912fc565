"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``gpu`` marker; every test skips where torch sees no CUDA device).
Imports torch and numpy only, so the file runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Token movement is exact, so every reassembly comparison is ``torch.equal``.
Attention is held to ``attention_ref`` at 1e-5 in float32 (another
summation order) and 2e-2 in bfloat16 (outputs rounded to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(8))
def test_cuda_window_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(600 + seed)
    B = int(rng.integers(1, 6))
    S = int(rng.choice([1, 4, 7, 1024, 1031]))
    w0 = int(rng.integers(0, 2 * (S + 1)))
    L = w0 + B * (S + 1) - int(rng.integers(0, S + 1))
    lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L).astype(np.int32))
    cuts = sorted(rng.choice(np.arange(1, L), size=min(4, L - 1),
                             replace=False).tolist())
    chunks = [c.to(cuda) for c in torch.tensor_split(lin, cuts)]
    kw = dict(global_batch=B, seq_len=S, window_tok_off=w0, pad_id=5)
    got = ops.ingest_chunks_window(chunks, **kw)
    want = ref.window_chunks_ref(chunks, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_cuda_block_and_token_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(700)
    src = torch.from_numpy(rng.standard_normal((7, 3, 33)).astype(np.float32)
                           ).to(cuda).to(dtype)
    idx = torch.tensor([6, 0, 0, 3], dtype=torch.int32, device=cuda)
    assert torch.equal(ops.reassemble(src, idx), ref.reassemble_ref(src, idx))
    staged = torch.arange(50, dtype=torch.int32, device=cuda)
    row_idx = torch.from_numpy(rng.integers(-1, 60, size=(3, 9)).astype(
        np.int32)).to(cuda)
    for g, w in zip(ops.reassemble_tokens(staged, row_idx, pad_id=2),
                    ref.tokens_gather_ref(staged, row_idx, pad_id=2)):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_ops_count_one_launch_each(cuda):
    K.reset_launch_counts()
    lin = torch.arange(40, dtype=torch.int32, device=cuda)
    ops.reassemble_window(lin, global_batch=2, seq_len=7)
    ops.reassemble(lin.reshape(8, 5), torch.tensor([1, 0], dtype=torch.int32,
                                                   device=cuda))
    ops.reassemble_tokens(lin, np.zeros((2, 8), np.int32))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"reassemble_window": 1, "reassemble": 1,
                          "reassemble_tokens": 1}


FA_CASES = [   # (B, H, K, Sq, Sk, hd, causal, window)
    (1, 2, 2, 64, 64, 32, True, 0),      # the six cases of
    (2, 4, 2, 128, 128, 64, True, 0),    # tests/test_kernels.py's sweep
    (1, 4, 1, 64, 64, 32, True, 0),
    (1, 2, 2, 64, 64, 32, True, 16),
    (1, 2, 2, 96, 96, 16, True, 24),
    (2, 2, 2, 64, 64, 32, False, 0),
    (1, 24, 8, 1, 1, 128, True, 0),      # phi4-mini decode
    (1, 24, 8, 1, 129, 128, True, 0),
    (2, 6, 2, 37, 70, 64, True, 9),      # ragged tiles, end-aligned
    (1, 32, 1, 5, 40, 16, True, 0),      # a group wider than a block
]
FA_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


def _attn_inputs(B, H, K, Sq, Sk, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device).to(dtype)
    return mk(B, H, Sq, hd), mk(B, K, Sk, hd), mk(B, K, Sk, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,window", FA_CASES)
def test_cuda_flash_attention_matches_plain(cuda, B, H, K, Sq, Sk, hd, causal,
                                            window, dtype, tol):
    q, k, v = _attn_inputs(B, H, K, Sq, Sk, hd, dtype, cuda, seed=Sk + hd)
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
def test_cuda_flash_attention_reads_a_cache_prefix_in_place(cuda, dtype, tol):
    # The decode call: (B, 1, H, hd) activations against the first pos+1
    # slots of a (B, C, K, hd) cache, through ops (strided views, no copy).
    rng = np.random.default_rng(5)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda).to(dtype)
    q, kc, vc = mk(2, 1, 24, 128), mk(2, 152, 8, 128), mk(2, 152, 8, 128)
    FA.reset_launch_counts()
    for pos in (0, 31, 32, 100):
        got = ops.flash_attention(q, kc[:, :pos + 1], vc[:, :pos + 1])
        want = ref.attention_ref(q.transpose(1, 2), kc[:, :pos + 1].transpose(
            1, 2), vc[:, :pos + 1].transpose(1, 2)).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    assert FA.LAUNCHES == {"flash_attention": 4}


@pytest.mark.gpu
def test_cuda_flash_attention_is_deterministic_and_checks_inputs(cuda):
    q, k, v = _attn_inputs(1, 24, 8, 300, 300, 128, torch.bfloat16, cuda)
    a = FA.flash_attention_cuda(q, k, v)
    b = FA.flash_attention_cuda(q, k, v)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_cuda(q[..., :96], k[..., :96], v[..., :96])
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention_cuda(q.half(), k.half(), v.half())
