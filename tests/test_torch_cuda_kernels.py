"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``gpu`` marker; every test skips where torch sees no CUDA device).
Imports torch and numpy only, so the file runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Token movement is exact, so every reassembly comparison is ``torch.equal``.
Attention is held to ``attention_ref`` at 1e-5 in float32 (another
summation order) and 2e-2 in bfloat16 (outputs rounded to bf16); the
selective scan to ``ssm_scan_ref`` at 1e-4, the tolerance of the
reference's own sweep (fp32, another summation order, FMA); the RG-LRU
recurrence to ``lru_scan_ref`` at 1e-5, that of its sweep (one FMA against
a product and a sum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402
from repro_torch.kernels import rglru_scan as LRU  # noqa: E402


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
    (1, 10, 1, 1, 1, 256, True, 0),      # recurrentgemma decode (MQA, hd 256)
    (1, 10, 1, 1, 129, 256, True, 0),
    (1, 10, 1, 1, 2048, 256, True, 0),   # a full ring
    (2, 10, 1, 70, 70, 256, True, 16),   # local-window prefill, ragged tiles
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


# -- the three paths of the redesigned kernel ----------------------------------

SPLIT_HEADS = [(24, 8, 128), (10, 1, 256)]     # phi4-mini, recurrentgemma


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
@pytest.mark.parametrize("H,K,hd", SPLIT_HEADS)
@pytest.mark.parametrize("Sk", [1, 63, 64, 65, 144, 2047, 2048])
def test_cuda_split_decode_at_split_boundaries(cuda, Sk, H, K, hd, dtype, tol):
    q, k, v = _attn_inputs(1, H, K, 1, Sk, hd, dtype, cuda, seed=Sk)
    FA.reset_launch_counts()
    got = FA.flash_attention_cuda(q, k, v)
    want = ref.attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention": 1}
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
@pytest.mark.parametrize("B,H,K,Sq,Sk,hd,causal,window", [
    (1, 24, 8, 1, 2048, 128, True, 100),   # a window drops 60 of 64 splits
    (1, 10, 1, 1, 2048, 256, True, 32),    # one split left: written directly
    (2, 4, 1, 3, 300, 128, True, 70),      # 3 positions x 4 heads a block
    (1, 2, 1, 4, 2, 128, True, 0),         # rows 0-1 keep no key: zeros
    (1, 2, 2, 2, 70, 32, False, 0),        # bidirectional
    (1, 8, 1, 2, 1000, 64, True, 0),       # 64-key spans: two tiles a split
    (1, 32, 1, 1, 5000, 16, True, 0),      # two group chunks, long spans
])
def test_cuda_split_decode_matches_split_plain(cuda, B, H, K, Sq, Sk, hd,
                                               causal, window, dtype, tol):
    q, k, v = _attn_inputs(B, H, K, Sq, Sk, hd, dtype, cuda, seed=Sk + Sq)
    assert FA.launch_plan(q.shape, k.shape, dtype)["path"] == "decode"
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.attention_split_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _odd_views(B, H, K, Sq, Sk, hd, dtype, device, how):
    """q, k, v with a dim stride of 2 ("strided") or offset by one element
    from a 16-byte boundary ("misaligned")."""
    rng = np.random.default_rng(Sq + Sk)

    def mk(*shape):
        n = int(np.prod(shape))
        if how == "strided":
            x = rng.standard_normal((*shape[:-1], 2 * shape[-1]))
            return torch.from_numpy(x.astype(np.float32)).to(device).to(
                dtype)[..., ::2]
        x = rng.standard_normal(n + 1).astype(np.float32)
        return torch.from_numpy(x).to(device).to(dtype)[1:].view(shape)
    return mk(B, H, Sq, hd), mk(B, K, Sk, hd), mk(B, K, Sk, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
@pytest.mark.parametrize("how", ["strided", "misaligned"])
@pytest.mark.parametrize("H,K,Sq,Sk,hd,window", [
    (24, 8, 1, 144, 128, 0),               # decode, scalar-load instantiation
    (10, 1, 1, 2048, 256, 0),
    (24, 8, 130, 130, 128, 0),             # prefill: tensor-core / fp32 tiles
    (10, 1, 97, 97, 256, 40),
])
def test_cuda_flash_attention_takes_odd_strides(cuda, how, H, K, Sq, Sk, hd,
                                               window, dtype, tol):
    q, k, v = _odd_views(1, H, K, Sq, Sk, hd, dtype, cuda, how)
    assert how != "strided" or k.stride(-1) == 2
    assert how != "misaligned" or k.data_ptr() % 16 != 0
    got = FA.flash_attention_cuda(q, k, v, window=window)
    want = ref.attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,Sk,hd", [(24, 8, 144, 128), (24, 8, 2048, 128),
                                       (10, 1, 129, 256), (10, 1, 2048, 256)])
def test_cuda_decode_row_is_bitwise_the_same_at_any_batch(cuda, H, K, Sk, hd,
                                                          dtype):
    # The continuous batcher's tokens equal the sequential oracle's only if
    # a row's bits do not depend on what else is in the batch.
    q, k, v = _attn_inputs(4, H, K, 1, Sk, hd, dtype, cuda, seed=Sk)
    batch = FA.flash_attention_cuda(q, k, v)
    again = FA.flash_attention_cuda(q, k, v)
    rows = [FA.flash_attention_cuda(q[i:i + 1], k[i:i + 1], v[i:i + 1])
            for i in range(4)]
    torch.cuda.synchronize()
    assert torch.equal(batch, again)
    for i in range(4):
        assert torch.equal(batch[i:i + 1], rows[i])


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("H,K,hd", [(8, 2, 64), (24, 8, 128), (10, 1, 256)])
@pytest.mark.parametrize("S", [1000, 2048])
def test_cuda_bf16_prefill_on_tensor_cores(cuda, S, H, K, hd, window):
    q, k, v = _attn_inputs(1, H, K, S, S, hd, torch.bfloat16, cuda, seed=S)
    assert FA.launch_plan(q.shape, k.shape, q.dtype)["path"] == "tensor_core"
    got = FA.flash_attention_cuda(q, k, v, window=window)
    want = ref.attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("H,K,S,hd,window", [(24, 8, 300, 128, 0),
                                             (10, 1, 257, 256, 64)])
def test_cuda_fp32_prefill_stays_within_1e5(cuda, H, K, S, hd, window):
    q, k, v = _attn_inputs(1, H, K, S, S, hd, torch.float32, cuda, seed=S)
    assert FA.launch_plan(q.shape, k.shape, q.dtype)["path"] == "cuda_core"
    got = FA.flash_attention_cuda(q, k, v, window=window)
    want = ref.attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_cuda_flash_attention_counts_one_launch_a_call(cuda):
    # A decode call that launches its combine kernel too still counts one.
    calls = [(1, 10, 1, 1, 2048, 256, torch.bfloat16),   # splits + combine
             (1, 24, 8, 1, 20, 128, torch.float32),      # one split
             (1, 24, 8, 64, 64, 128, torch.bfloat16),    # tensor cores
             (1, 24, 8, 64, 64, 128, torch.float32)]     # fp32 tiles
    FA.reset_launch_counts()
    for B, H, K, Sq, Sk, hd, dtype in calls:
        FA.flash_attention_cuda(*_attn_inputs(B, H, K, Sq, Sk, hd, dtype, cuda))
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention": len(calls)}


SCAN_CASES = [   # (B, S, D, N)
    (1, 32, 16, 4), (2, 64, 32, 8), (1, 128, 64, 16), (2, 96, 16, 4),  # sweep
    (1, 1, 8192, 16),                    # falcon-mamba decode
    (1, 64, 8192, 16),                   # a 64-token prefill
    (3, 7, 100, 32), (2, 5, 33, 1),      # ragged channel counts, N extremes
]


def _scan_inputs(B, S, D, N, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return (mk(1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D, N))))),
            mk(rng.standard_normal((B, S, D, N)) * 0.1),
            mk(rng.standard_normal((B, S, N))),
            mk(rng.standard_normal((B, D, N)) * 0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,D,N", SCAN_CASES)
def test_cuda_mamba_scan_matches_plain(cuda, B, S, D, N):
    A, Bx, C, h0 = _scan_inputs(B, S, D, N, cuda, seed=S + D)
    y, h = MS.mamba_scan_cuda(A, Bx, C)
    assert h is None
    torch.testing.assert_close(y, ref.ssm_scan_ref(A, Bx, C), atol=1e-4,
                               rtol=1e-4)
    y, h = MS.mamba_scan_cuda(A, Bx, C, h0=h0, return_state=True)
    y_ref, h_ref = ref.ssm_scan_ref(A, Bx, C, h0, return_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_mamba_scan_counts_launches_and_is_deterministic(cuda):
    A, Bx, C, h0 = _scan_inputs(2, 9, 64, 16, cuda)
    MS.reset_launch_counts()
    a = ops.mamba_scan(A, Bx, C)
    b, h = ops.mamba_scan(A, Bx, C, h0=h0, return_state=True)
    c, h2 = ops.mamba_scan(A, Bx, C, h0=h0, return_state=True)
    assert MS.LAUNCHES == {"mamba_scan": 3}
    assert torch.equal(b, c) and torch.equal(h, h2)
    assert a.shape == (2, 9, 64) and h.shape == (2, 64, 16)


@pytest.mark.gpu
def test_cuda_mamba_scan_refuses_autograd_and_bad_inputs(cuda):
    A, Bx, C, h0 = _scan_inputs(1, 4, 32, 16, cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.mamba_scan(A.requires_grad_(), Bx, C)
    with torch.no_grad():
        ops.mamba_scan(A, Bx, C)                 # no gradient needed: runs
    A = A.detach()
    with pytest.raises(ValueError, match="contiguous"):
        MS.mamba_scan_cuda(A.transpose(2, 3).contiguous().transpose(2, 3),
                           Bx, C)
    with pytest.raises(ValueError, match="float32"):
        MS.mamba_scan_cuda(A.double(), Bx, C)
    with pytest.raises(ValueError, match="state size"):
        MS.mamba_scan_cuda(A[..., :12].contiguous(), Bx[..., :12].contiguous(),
                           C[..., :12].contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        MS.mamba_scan_cuda(A, Bx, C.cpu())


LRU_CASES = [   # (B, S, W)
    (1, 32, 16), (2, 64, 64), (1, 256, 32),        # the sweep
    (3, 37, 50),                                   # ragged
    (1, 1, 2560),                                  # recurrentgemma decode
    (1, 2100, 2560),                               # a prompt past the window
]


def _lru_inputs(B, S, W, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    return (mk(1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))),
            mk(rng.standard_normal((B, S, W)) * 0.1),
            mk(rng.standard_normal((B, W)) * 0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,W", LRU_CASES)
def test_cuda_rglru_scan_matches_plain(cuda, B, S, W):
    a, b, h0 = _lru_inputs(B, S, W, cuda, seed=S + W)
    torch.testing.assert_close(LRU.rglru_scan_cuda(a, b),
                               ref.lru_scan_ref(a, b), atol=1e-5, rtol=1e-5)
    h = LRU.rglru_scan_cuda(a, b, h0=h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(h, ref.lru_scan_ref(a, b, h0), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.gpu
def test_cuda_rglru_scan_counts_launches_and_is_deterministic(cuda):
    a, b, h0 = _lru_inputs(2, 9, 300, cuda)
    LRU.reset_launch_counts()
    x = ops.rglru_scan(a, b)
    y = ops.rglru_scan(a, b, h0=h0)
    z = ops.rglru_scan(a, b, h0=h0)
    assert LRU.LAUNCHES == {"rglru_scan": 3}
    assert torch.equal(y, z) and x.shape == (2, 9, 300)
    # A decode step is the scan with S = 1: one FMA from h0.
    one = ops.rglru_scan(a[:, :1].contiguous(), b[:, :1].contiguous(), h0=h0)
    torch.testing.assert_close(one[:, 0], a[:, 0] * h0 + b[:, 0], atol=1e-6,
                               rtol=1e-6)


@pytest.mark.gpu
def test_cuda_rglru_scan_refuses_autograd_and_bad_inputs(cuda):
    a, b, h0 = _lru_inputs(1, 4, 32, cuda)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.rglru_scan(a.requires_grad_(), b)
    with torch.no_grad():
        ops.rglru_scan(a, b)                     # no gradient needed: runs
    a = a.detach()
    with pytest.raises(ValueError, match="contiguous"):
        LRU.rglru_scan_cuda(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="float32"):
        LRU.rglru_scan_cuda(a.double(), b)
    with pytest.raises(ValueError, match="h0"):
        LRU.rglru_scan_cuda(a, b, h0=h0[:, :7].contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        LRU.rglru_scan_cuda(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
def test_cuda_flash_attention_over_a_wrapped_ring(cuda, dtype, tol):
    # The decode call past the window: the new token at slot pos % C of a
    # full ring, attended over all C slots with no window. The same
    # function as the plain version over the last C positions in order.
    rng = np.random.default_rng(9)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda).to(dtype)
    C, pos = 64, 150
    q, kc, vc = mk(1, 1, 10, 256), mk(1, C, 1, 256), mk(1, C, 1, 256)
    got = ops.flash_attention(q, kc, vc, causal=True, window=0)
    order = [(p % C) for p in range(pos - C + 1, pos + 1)]
    want = ref.attention_ref(
        q.transpose(1, 2), kc[:, order].transpose(1, 2),
        vc[:, order].transpose(1, 2), causal=True, window=C).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
