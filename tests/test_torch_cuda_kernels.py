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
a product and a sum, and a chunked carry). The fused entries are held to
their plain versions at the same fp32 tolerances (``y`` and the final
state) and, in bfloat16, ``y`` at 2e-2 (one bf16 step of the output); the
bf16 softplus and silu inside the Mamba kernel are held bit for bit to
torch's over all 65,536 inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402
from repro_torch.kernels import rglru_scan as LRU  # noqa: E402
from repro_torch.models import ssm  # noqa: E402


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


def _chunks_at(lin, cuts, dev, skew=0):
    """``lin`` cut at ``cuts`` into separate allocations; with ``skew`` the
    odd chunks are views ``skew`` tokens into their buffer, so that their
    base is off a 16-byte boundary."""
    out = []
    for i, c in enumerate(torch.tensor_split(lin, cuts)):
        s = skew if i % 2 else 0
        buf = torch.empty(c.numel() + s, dtype=torch.int32, device=dev)
        buf[s:] = c.to(dev)
        out.append(buf[s:])
    return out


def _window_equal(chunks, **kw):
    got = K.reassemble_window_cuda(chunks, **kw)
    want = ref.window_chunks_ref(chunks, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_cuda_window_table_at_the_by_value_cap(cuda, extra):
    """kMaxParamChunks - 1, kMaxParamChunks and kMaxParamChunks + 1
    chunks: the first two go by value and upload nothing, the last takes
    the device-table instance of the kernel."""
    n = K.max_param_chunks() + extra
    rng = np.random.default_rng(800 + extra)
    B, S = 3, 509
    L = B * (S + 1) + 7
    lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L).astype(np.int32))
    cuts = np.sort(rng.choice(np.arange(1, L), size=n - 1, replace=False))
    chunks = _chunks_at(lin, cuts.tolist(), cuda, skew=1)
    K.reset_launch_counts()
    _window_equal(chunks, global_batch=B, seq_len=S, window_tok_off=5,
                  pad_id=4)
    assert K.LAUNCHES["reassemble_window"] == 1
    assert K.TABLE_UPLOADS == (1 if extra > 0 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("h", [0, 1, 2, 3])
@pytest.mark.parametrize("S", [2048, 2051, 127])
def test_cuda_window_row_misalignment_and_chunk_edges(cuda, h, S):
    """Every row misalignment h (the window's offset mod 4; rows after the
    first shift by (S+1) mod 4 each), chunk edges inside a 4-token group
    and inside a warp's span (every 37 and 130 tokens), skewed chunk bases,
    a remainder window and pads past the valid limit."""
    rng = np.random.default_rng(810 + h + S)
    B = 5
    w0 = 8 + h
    L = w0 + B * (S + 1) - S // 2            # the last row runs off the end
    lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L).astype(np.int32))
    for step, skew in ((37, 1), (130, 2), (L, 0)):
        cuts = list(range(step, L, step))
        chunks = _chunks_at(lin, cuts, cuda, skew=skew)
        for valid in (None, w0 + 2 * (S + 1) + 3):
            _window_equal(chunks, global_batch=B, seq_len=S,
                          window_tok_off=w0, valid_limit=valid, pad_id=9)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 1), (1, 5), (1, 2048), (8, 2048),
                                 (3, 4097), (513, 2048)])
def test_cuda_window_shapes_and_no_upload_on_the_main_path(cuda, B, S):
    """B = 1, S not a multiple of 4, the main path's window (one chunk and
    four), and a window past 2^20 columns."""
    rng = np.random.default_rng(820 + B + S)
    L = B * (S + 1)
    lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L).astype(np.int32))
    K.reset_launch_counts()
    for cuts in ([], [L // 4, L // 2, 3 * L // 4]):
        _window_equal(_chunks_at(lin, cuts, cuda), global_batch=B, seq_len=S)
    assert K.LAUNCHES["reassemble_window"] == 2
    assert K.TABLE_UPLOADS == 0


@pytest.mark.gpu
def test_cuda_window_many_small_chunks_past_the_cap(cuda):
    """A large window over 16 KiB chunks (1,025 of them), as a large
    window of small splinters arrives: the device-table instance."""
    rng = np.random.default_rng(830)
    B, S = 512, 2048
    L = B * (S + 1)
    lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L).astype(np.int32))
    chunks = _chunks_at(lin, list(range(4096, L, 4096)), cuda)
    assert len(chunks) > K.max_param_chunks()
    K.reset_launch_counts()
    _window_equal(chunks, global_batch=B, seq_len=S, valid_limit=L - 100,
                  pad_id=1)
    assert K.TABLE_UPLOADS == 1


@pytest.mark.gpu
def test_cuda_window_by_value_cap_is_128(cuda):
    assert K.max_param_chunks() == 128


@pytest.mark.gpu
@pytest.mark.parametrize("S", [3, 4, 5])
def test_cuda_window_rows_past_the_grid(cuda, S):
    """B = 65,537 rows, two more than the grid's y extent: the rows past
    it are taken by the kernel's row loop (S = 4 with 16-byte stores,
    3 and 5 with scalar ones), in one chunk and in 16 KiB chunks."""
    rng = np.random.default_rng(850 + S)
    B = 65537
    L = B * (S + 1) + 2
    lin = torch.from_numpy(rng.integers(0, 1 << 30, size=L).astype(np.int32))
    for cuts in ([], list(range(4096, L, 4096))):
        _window_equal(_chunks_at(lin, cuts, cuda), global_batch=B, seq_len=S,
                      window_tok_off=1, valid_limit=L - 3, pad_id=6)


def _tokens_equal(staged, row_idx, pad_id=3):
    got = K.reassemble_tokens_cuda(staged, row_idx, pad_id=pad_id)
    want = ref.tokens_gather_ref(staged, row_idx, pad_id=pad_id)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S", [(1, 1), (1, 6), (2, 127), (3, 128),
                                 (4, 129), (8, 2048), (2, 2051), (600, 2048)])
@pytest.mark.parametrize("kind", ["runs", "random"])
def test_cuda_token_gather_runs_random_pads_and_clips(cuda, B, S, kind):
    """Arrival-ordered maps (runs of contiguous staged positions) and
    random ones, pads in column 0, column S and at warp (128-column) and
    tile (1,024-column) edges, indices past L that clip; B = 1 and S not a
    multiple of 4."""
    rng = np.random.default_rng(840 + B + S)
    n = B * (S + 1)
    L = n + 11
    staged = torch.from_numpy(rng.integers(0, 200064, size=L).astype(
        np.int32)).to(cuda)
    if kind == "runs":
        run = 37
        starts = rng.permutation(L // run) * run
        flat = (starts[:, None] + np.arange(run)[None, :]).reshape(-1)
        flat = np.resize(flat, n)
    else:
        flat = rng.integers(0, L, size=n)
    row_idx = flat.reshape(B, S + 1).astype(np.int32)
    row_idx[:, 0] = -1
    row_idx[:, S] = -1
    for col in (127, 128, 1023, 1024, 1025):
        if col <= S:
            row_idx[:, col] = -1
    row_idx[:, 1::7] += L                  # past the buffer: clip to L - 1
    _tokens_equal(staged, torch.from_numpy(row_idx).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [3, 4, 5])
def test_cuda_token_gather_rows_past_the_grid(cuda, S):
    """B = 65,537 rows, two more than the grid's y extent, on a random map
    with pads and clipped indices."""
    rng = np.random.default_rng(860 + S)
    B = 65537
    L = B * (S + 1)
    staged = torch.from_numpy(rng.integers(0, 200064, size=L).astype(
        np.int32)).to(cuda)
    row_idx = rng.integers(-1, L + 5, size=(B, S + 1)).astype(np.int32)
    _tokens_equal(staged, torch.from_numpy(row_idx).to(cuda))


@pytest.mark.gpu
def test_cuda_token_gather_counts_one_launch(cuda):
    staged = torch.arange(100, dtype=torch.int32, device=cuda)
    row_idx = torch.arange(33, dtype=torch.int32, device=cuda).reshape(3, 11)
    K.reset_launch_counts()
    _tokens_equal(staged, row_idx)
    assert K.LAUNCHES["reassemble_tokens"] == 1
    assert K.TABLE_UPLOADS == 0


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


# The decode shapes of the five text families served since: codeqwen
# (32/32, G = 1), phi3-medium (40/10, G = 4), the two MoE families (16/16,
# G = 1) and gemma3 (32/16, G = 2) with its 1,024-key local window, passed
# while a local ring fills (Sk <= 1,024) and dropped once it has wrapped
# (Sk = 1,024, every slot kept), and its global layers (no window, Sk past
# the window). Key counts at the 32-key spans' edges, the served prefixes
# (64-token prompts and 16 new tokens) and long ones (span 96 at 4,100).
FAMILY_DECODE = [
    *[(h, k, sk, 0) for h, k in ((32, 32), (40, 10), (16, 16))
      for sk in (1, 63, 64, 65, 80, 2048, 4100)],
    *[(32, 16, sk, 1024) for sk in (1, 65, 80, 1023, 1024)],
    (32, 16, 1024, 0), (32, 16, 1100, 0), (32, 16, 4100, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("H,K,Sk,window", FAMILY_DECODE)
def test_cuda_decode_at_the_served_families_shapes(cuda, H, K, Sk, window, B,
                                                   dtype, tol):
    q, k, v = _attn_inputs(B, H, K, 1, Sk, 128, dtype, cuda, seed=Sk + H)
    plan = FA.launch_plan(q.shape, k.shape, dtype, window=window)
    assert plan["path"] == "decode"
    FA.reset_launch_counts()
    got = FA.flash_attention_cuda(q, k, v, window=window)
    want = ref.attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# The last two families: qwen2-vl decode (12/2, G = 6, hd 128), whisper's
# self-attention decode (16/16 at hd 64, up to its 448-token cap), its
# cross-attention over the 1,500 frames (Sq = 1, no mask: the last of 24
# 64-key splits holds 28 keys) and its encoder (Sq = Sk = 1,500, no mask:
# the tensor-core path in bf16, whose 64-row blocks leave 28 rows in the
# last one, and the CUDA-core path in fp32).
LAST_FAMILIES = [
    *[(12, 2, 1, sk, 128, True) for sk in (1, 17, 80, 129, 2048)],
    *[(16, 16, 1, sk, 64, True) for sk in (1, 17, 80, 129, 448)],
    (16, 16, 1, 1500, 64, False),
    (16, 16, 1500, 1500, 64, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FA_DTYPES)
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("H,K,Sq,Sk,hd,causal", LAST_FAMILIES)
def test_cuda_attention_at_qwen2_vl_and_whisper_shapes(cuda, H, K, Sq, Sk, hd,
                                                       causal, B, dtype, tol):
    q, k, v = _attn_inputs(B, H, K, Sq, Sk, hd, dtype, cuda, seed=Sk + H)
    want_path = ("decode" if Sq == 1 else
                 "tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    assert FA.launch_plan(q.shape, k.shape, dtype)["path"] == want_path
    FA.reset_launch_counts()
    got = FA.flash_attention_cuda(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention": 1}
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if Sq == 1 and B == 4:          # a row's bits do not depend on B
        alone = FA.flash_attention_cuda(q[2:3], k[2:3], v[2:3], causal=causal)
        assert torch.equal(got[2:3], alone)


@pytest.mark.gpu
def test_cuda_flash_attention_refuses_autograd(cuda):
    # (B, H, S, hd) inputs; ops takes (B, S, H, hd) views of them.
    q, k, v = (t.transpose(1, 2) for t in _attn_inputs(
        1, 16, 16, 40, 40, 64, torch.bfloat16, cuda, seed=1))
    FA.reset_launch_counts()
    with pytest.raises(NotImplementedError) as e:
        ops.flash_attention(q, k.requires_grad_(), v, causal=False)
    assert str(e.value) == FA.FORWARD_ONLY and "forward-only" in str(e.value)
    assert FA.LAUNCHES == {"flash_attention": 0}
    with torch.no_grad():
        ops.flash_attention(q, k, v, causal=False)   # no gradient needed
    assert FA.LAUNCHES == {"flash_attention": 1}


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
                                       (10, 1, 129, 256), (10, 1, 2048, 256),
                                       (32, 32, 80, 128), (40, 10, 80, 128),
                                       (16, 16, 80, 128), (32, 16, 1024, 128),
                                       (32, 16, 1100, 128)])
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
    assert MS.LAUNCHES == {"mamba_scan": 3, "mamba_scan_fused": 0}
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
    assert LRU.LAUNCHES == {"rglru_scan": 3, "rglru_scan_gated": 0}
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


# -- the fused entries -----------------------------------------------------------
FUSED_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]
FUSED_CASES = [   # (B, S, D, N, r)
    (2, 37, 100, 16, 3),       # ragged D, proj rows not 16-byte aligned
    (1, 1, 8192, 16, 256),     # falcon-mamba decode (proj row 288 values)
    (1, 64, 8192, 16, 256),    # a 64-token prefill
    (3, 70, 33, 4, 5), (2, 9, 40, 32, 7), (2, 5, 64, 1, 0),
    # 16-byte runs with a last tile cut short: N = 8, 16 and 32
    (2, 72, 128, 8, 8), (2, 45, 256, 16, 256), (1, 100, 64, 32, 16),
]


def _fused_inputs(B, S, D, N, r, dtype, device, seed=0, channel_major=False):
    """xin (channel-major when asked, the conv's layout), z a view of an
    (B, S, 2D) product, proj rows of r + 2N values; fp32 parameters."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    xin = (f(B, D, S).transpose(1, 2) if channel_major else f(B, S, D))
    t = {"xin": xin.to(dtype), "dt_pre": (f(B, S, D) * 0.5).to(dtype),
         "dt_bias": np.log(np.expm1(1e-2)) + f(D) * 0.1,
         "A_log": torch.log(torch.arange(1, N + 1, device=device,
                                         dtype=torch.float32)).repeat(D, 1)
         + f(D, N) * 0.1,
         "proj": f(B, S, r + 2 * N).to(dtype), "Dskip": 1.0 + f(D) * 0.1,
         "z": f(B, S, 2 * D).to(dtype)[..., D:], "h0": f(B, D, N) * 0.5}
    return t


def _fargs(t):
    return (t["xin"], t["dt_pre"], t["dt_bias"], t["A_log"], t["proj"],
            t["Dskip"], t["z"])


def _within(got, want, tol):
    """|got - want| <= tol + tol * |want| in fp32 (chip_smoke's rule)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= tol + tol * w.abs()).all()), (
        (g - w).abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", FUSED_DTYPES)
@pytest.mark.parametrize("B,S,D,N,r", FUSED_CASES)
def test_cuda_mamba_scan_fused_matches_plain(cuda, B, S, D, N, r, dtype, tol):
    for channel_major in (False, True):
        t = _fused_inputs(B, S, D, N, r, dtype, cuda, seed=S + D,
                          channel_major=channel_major)
        y, h = MS.mamba_scan_fused_cuda(*_fargs(t), return_state=True)
        y_ref, h_ref = ref.mamba_scan_fused_ref(*_fargs(t), return_state=True)
        _within(y, y_ref, tol)
        _within(h, h_ref, 1e-4)
        y, h = MS.mamba_scan_fused_cuda(*_fargs(t), h0=t["h0"],
                                        return_state=True)
        y_ref, h_ref = ref.mamba_scan_fused_ref(*_fargs(t), t["h0"],
                                                return_state=True)
        torch.cuda.synchronize()
        _within(y, y_ref, tol)
        _within(h, h_ref, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,N,r", [(2, 72, 128, 8, 8), (1, 64, 8192, 16, 256),
                                       (2, 96, 64, 32, 16)])
def test_cuda_mamba_scan_fused_16_byte_path_gives_the_scalar_bits(
        cuda, B, S, D, N, r, dtype):
    # Aligned views take fused_kernel's 16-byte path (cp.async rows of
    # Bc/Cc, vector loads of dt_pre, z and xin along d or along t); the
    # same values with proj rows one value longer take the scalar path.
    for channel_major in (False, True):
        t = _fused_inputs(B, S, D, N, r, dtype, cuda, seed=7,
                          channel_major=channel_major)
        padded = torch.zeros((B, S, r + 2 * N + 1), dtype=dtype, device=cuda)
        padded[..., :r + 2 * N] = t["proj"]
        args = list(_fargs(t))
        y, h = MS.mamba_scan_fused_cuda(*args, h0=t["h0"], return_state=True)
        args[4] = padded[..., :r + 2 * N]
        y2, h2 = MS.mamba_scan_fused_cuda(*args, h0=t["h0"],
                                          return_state=True)
        assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_decode_rows_are_bitwise_the_same_at_any_batch(cuda, dtype):
    t = _fused_inputs(4, 1, 8192, 16, 256, dtype, cuda, seed=1)
    y, h = MS.mamba_scan_fused_cuda(*_fargs(t), h0=t["h0"], return_state=True)
    y2, h2 = MS.mamba_scan_fused_cuda(*_fargs(t), h0=t["h0"],
                                      return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for i in range(4):
        row = {k: (v[i:i + 1] if v.dim() == 3 and k != "A_log" else v)
               for k, v in t.items()}
        yi, hi = MS.mamba_scan_fused_cuda(*_fargs(row), h0=row["h0"],
                                          return_state=True)
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(hi, h[i:i + 1])
    g = _gated_inputs(4, 1, 2560, dtype, cuda, seed=1)
    y, h = LRU.rglru_scan_gated_cuda(*_gargs(g), h0=g["h0"], return_state=True)
    y2, h2 = LRU.rglru_scan_gated_cuda(*_gargs(g), h0=g["h0"],
                                       return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for i in range(4):
        row = {k: (v[i:i + 1] if v.dim() > 1 else v) for k, v in g.items()}
        yi, hi = LRU.rglru_scan_gated_cuda(*_gargs(row), h0=row["h0"],
                                           return_state=True)
        assert torch.equal(yi, y[i:i + 1]) and torch.equal(hi, h[i:i + 1])


def _gated_inputs(B, S, W, dtype, device, seed=0, channel_major=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    xr = f(B, W, S).transpose(1, 2) if channel_major else f(B, S, W)
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, W, device=device)) / 8.0))
    return {"r_pre": f(B, S, W), "i_pre": f(B, S, W), "b_r": f(W) * 0.1,
            "b_i": f(W) * 0.1, "lam": lam, "xr": xr.to(dtype),
            "gate": f(B, S, W).to(dtype), "h0": f(B, W) * 0.5}


def _gargs(g):
    return (g["r_pre"], g["i_pre"], g["b_r"], g["b_i"], g["lam"], g["xr"],
            g["gate"])


GATED_CASES = [(3, 37, 50), (1, 1, 2560), (1, 2100, 2560), (2, 129, 64),
               (2, 300, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,W", GATED_CASES)
def test_cuda_rglru_scan_gated_matches_plain(cuda, B, S, W, dtype, tol):
    for channel_major in (False, True):
        g = _gated_inputs(B, S, W, dtype, cuda, seed=S + W,
                          channel_major=channel_major)
        for h0 in (None, g["h0"]):
            y, h = LRU.rglru_scan_gated_cuda(*_gargs(g), h0=h0,
                                             return_state=True)
            y_ref, h_ref = ref.rglru_scan_gated_ref(*_gargs(g), h0,
                                                    return_state=True)
            torch.cuda.synchronize()
            _within(y, y_ref, tol)
            _within(h, h_ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [7, 8, 9, 127, 128, 129, 255, 257])
def test_cuda_rglru_scan_across_chunk_and_segment_edges(cuda, S):
    a, b, h0 = _lru_inputs(2, S, 96, cuda, seed=S)
    for init in (None, h0):
        h = LRU.rglru_scan_cuda(a, b, h0=init)
        torch.cuda.synchronize()
        torch.testing.assert_close(h, ref.lru_scan_ref(a, b, init), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.gpu
def test_cuda_fused_entries_count_one_launch_a_call(cuda):
    t = _fused_inputs(2, 9, 64, 16, 4, torch.bfloat16, cuda)
    g = _gated_inputs(2, 9, 64, torch.bfloat16, cuda)
    MS.reset_launch_counts()
    LRU.reset_launch_counts()
    ops.mamba_scan_fused(*_fargs(t))
    ops.mamba_scan_fused(*_fargs(t), h0=t["h0"], return_state=True)
    ops.rglru_scan_gated(*_gargs(g), h0=g["h0"])
    assert MS.LAUNCHES == {"mamba_scan": 0, "mamba_scan_fused": 2}
    assert LRU.LAUNCHES == {"rglru_scan": 0, "rglru_scan_gated": 1}
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.mamba_scan_fused(t["xin"].requires_grad_(), *_fargs(t)[1:])
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.rglru_scan_gated(g["r_pre"].requires_grad_(), *_gargs(g)[1:])
    assert MS.LAUNCHES["mamba_scan_fused"] == 2
    assert LRU.LAUNCHES["rglru_scan_gated"] == 1


def _all_bf16(device):
    return torch.arange(-32768, 32768, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16).reshape(1, 1, -1)


def _bits_differ(got, want):
    both_nan = torch.isnan(got) & torch.isnan(want)
    return int((~((got == want) | both_nan)).sum())


@pytest.mark.gpu
def test_cuda_fused_softplus_and_silu_round_as_torch_does(cuda):
    # Every bf16 value as dt_pre with zero bias, Bc = xin = 1, h0 = 0: the
    # final state of each channel is the kernel's bf16 dt. Then every value
    # as z with Bc = 0 and D = xin = 1: y is the kernel's bf16 silu(z).
    v = _all_bf16(cuda)
    D = v.shape[-1]
    one = torch.ones_like(v)
    zero = torch.zeros_like(v)
    f0 = torch.zeros(D, device=cuda)
    proj1 = torch.ones((1, 1, 2), dtype=torch.bfloat16, device=cuda)
    A_log = torch.zeros((D, 1), device=cuda)
    _, h = MS.mamba_scan_fused_cuda(one, v, f0, A_log, proj1, f0, zero,
                                    return_state=True)
    softplus = _bits_differ(h[0, :, 0], F.softplus(v[0, 0]).float())
    y, _ = MS.mamba_scan_fused_cuda(one, zero, f0, A_log, torch.zeros_like(
        proj1), torch.ones(D, device=cuda), v)
    silu = _bits_differ(y[0, 0].float(), F.silu(v[0, 0]).float())
    print(f"bf16 inputs where the kernel differs from torch: softplus "
          f"{softplus}, silu {silu}")
    assert (softplus, silu) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_decode_steps_give_the_unfused_layers_bits(cuda, dtype):
    # One decode step of each fused entry against the layer it replaces on
    # the card (torch ops around the literal kernel), bit for bit: the
    # fused kernels round where torch rounds, with torch's exp, softplus,
    # silu, sigmoid and sqrt, and sum in the literal kernels' order.
    t = _fused_inputs(2, 1, 8192, 16, 256, dtype, cuda, seed=4)
    y, h = MS.mamba_scan_fused_cuda(*_fargs(t), h0=t["h0"], return_state=True)
    Abar, Bx, Cc = ssm.discretize(t["dt_pre"], t["dt_bias"], t["A_log"],
                                  t["proj"], t["xin"])
    y_ref, h_ref = MS.mamba_scan_cuda(Abar, Bx, Cc, h0=t["h0"],
                                      return_state=True)
    y_ref = (y_ref.to(dtype) + t["Dskip"].to(dtype) * t["xin"]) * F.silu(t["z"])
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    g = _gated_inputs(2, 1, 2560, dtype, cuda, seed=4)
    y, h = LRU.rglru_scan_gated_cuda(*_gargs(g), h0=g["h0"], return_state=True)
    r = torch.sigmoid(g["r_pre"] + g["b_r"])
    i = torch.sigmoid(g["i_pre"] + g["b_i"])
    log_a = -8.0 * F.softplus(g["lam"]) * r
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h_ref = LRU.rglru_scan_cuda(torch.exp(log_a).contiguous(),
                                (beta * i * g["xr"].float()).contiguous(),
                                h0=g["h0"])
    torch.cuda.synchronize()
    assert torch.equal(h, h_ref[:, -1])
    assert torch.equal(y, h_ref.to(dtype) * g["gate"])


@pytest.mark.gpu
@pytest.mark.parametrize("use_ckio", [False, True])
def test_cuda_checkpoint_round_trip_is_bit_equal(cuda, tmp_path, use_ckio):
    """Leaves on the card (fp32, bf16, an int step) -> a packed file -> a
    CkIO session (or plain reads) -> the card, bit for bit."""
    from repro_torch.train import restore_tree, save_checkpoint

    rng = np.random.default_rng(800)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    tree = {"w": f32(257, 33), "b": f32(1000).bfloat16(),
            "layers": [{"s": f32(3), "t": f32(64, 65).bfloat16()}],
            "step": 11}
    path = str(tmp_path / "card.ckpt")
    save_checkpoint(path, tree, step=11)
    like = {"w": torch.zeros_like(tree["w"]), "b": torch.zeros_like(tree["b"]),
            "layers": [{k: torch.zeros_like(v)
                        for k, v in tree["layers"][0].items()}], "step": 0}
    got, step = restore_tree(path, like, use_ckio=use_ckio)
    assert step == 11 and got["step"] == 11
    pairs = [(got["w"], tree["w"]), (got["b"], tree["b"])] + [
        (got["layers"][0][k], v) for k, v in tree["layers"][0].items()]
    for g, w in pairs:
        assert g.device == w.device and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_checkpoint_restores_into_the_live_tensors(cuda, tmp_path):
    """A file read without a like-tree (host tensors) is written into
    tensors on the card in place, bit for bit."""
    from repro_torch.train import load_into, restore_tree, save_checkpoint

    rng = np.random.default_rng(801)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda)
    tree = {"w": f32(257, 33), "b": f32(1000).bfloat16(), "step": 11}
    path = str(tmp_path / "card.ckpt")
    save_checkpoint(path, tree, step=11)
    live = {"w": f32(257, 33), "b": f32(1000).bfloat16(), "step": 0}
    ptrs = (live["w"].data_ptr(), live["b"].data_ptr())
    got = load_into(restore_tree(path)[0], live)
    assert (got["w"].data_ptr(), got["b"].data_ptr()) == ptrs
    assert got["step"] == 11
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["b"], tree["b"])


@pytest.mark.gpu
def test_cuda_kernel_error_passes_through_the_supervisor(cuda, tmp_path):
    """A launch the CUDA runtime refuses (a grid of zero blocks) raises
    ``KernelError`` from the wrapper's ``check_rc``; the supervisor lets it
    through on the first failure, with no restore, and the card works on
    (the error is not sticky)."""
    from repro_torch.train import AsyncCheckpointer, StepSupervisor

    src = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    out = torch.empty_like(src)

    def step_fn(state, batch):
        if state["step"] == 1:
            rc = K._library().ckio_reassemble(
                src.data_ptr(), idx.data_ptr(), out.data_ptr(), 0, 32, 16,
                K.stream_of(out))
            K.check_rc(rc, "reassemble")
        return {"x": state["x"] + 1, "step": state["step"] + 1}, {}

    ck = AsyncCheckpointer(str(tmp_path / "ckpt"), keep=2)
    sup = StepSupervisor(step_fn, ck, ckpt_every=1, max_retries=3)
    with pytest.raises(K.KernelError, match="reassemble: CUDA error"):
        sup.run({"x": torch.zeros((), device=cuda), "step": 0},
                lambda s: None, 3)
    ck.shutdown()
    assert (sup.stats.failures, sup.stats.restores, sup.stats.steps_run) == (0, 0, 1)
    lin = torch.arange(40, dtype=torch.int32, device=cuda)
    got = ops.reassemble_window(lin, global_batch=2, seq_len=7)
    want = ref.window_chunks_ref([lin], global_batch=2, seq_len=7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
