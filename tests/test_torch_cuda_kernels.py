"""The CUDA reassembly kernels against their plain PyTorch versions, on the
card (``gpu`` marker; every test skips where torch sees no CUDA device).
Imports torch and numpy only, so the file runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Token movement is exact, so every comparison is ``torch.equal``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
