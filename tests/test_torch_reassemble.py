"""Port reassembly ops vs the reference's Pallas kernels (interpret mode).

The same NumPy inputs go through ``repro.kernels.ops`` with
``use_pallas=True`` and through ``repro_torch.kernels.ops`` on CPU tensors
(the plain PyTorch versions). Token movement must be bit-equal, so every
comparison is exact. The CUDA kernels themselves are held against the same
plain versions on the card (``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data.packing import as_block_permutation, token_gather_from_pieces  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402


def np_batch_oracle(linear, B, S, w0=0, valid_limit=None, pad_id=0):
    S1 = S + 1
    full_limit = w0 + B * S1
    if valid_limit is None:
        valid_limit = full_limit
    buf = np.full(full_limit + 1, pad_id, dtype=linear.dtype)
    n = min(linear.size, full_limit + 1)
    buf[:n] = linear[:n]
    pos = w0 + np.arange(B)[:, None] * S1 + np.arange(S1 + 1)[None, :]
    rows = buf[pos]
    inputs = np.where(pos[:, :S] < valid_limit, rows[:, :S], pad_id)
    labels = np.where(pos[:, 1:S + 1] < valid_limit, rows[:, 1:S + 1], pad_id)
    return inputs, labels


def random_arrival_pieces(rng, session_off, num_tokens, itemsize):
    ncuts = int(rng.integers(0, min(7, num_tokens - 1) + 1))
    cuts = np.sort(rng.choice(np.arange(1, num_tokens), size=ncuts,
                              replace=False)) if ncuts else np.array([], int)
    bounds = [0, *cuts.tolist(), num_tokens]
    pieces = [(session_off + bounds[i] * itemsize,
               (bounds[i + 1] - bounds[i]) * itemsize)
              for i in range(len(bounds) - 1)]
    rng.shuffle(pieces)
    return pieces


def assert_same(port, jax_out, want=None):
    port = port if isinstance(port, tuple) else (port,)
    jax_out = jax_out if isinstance(jax_out, (tuple, list)) else (jax_out,)
    for i, (p, j) in enumerate(zip(port, jax_out)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        if want is not None:
            np.testing.assert_array_equal(p.numpy(), want[i])


# -- tests/test_device_ingest.py cases -----------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_window_random_offsets_and_remainders(seed):
    rng = np.random.default_rng(100 + seed)
    B = int(rng.integers(1, 5))
    S = int(rng.integers(2, 17))
    S1 = S + 1
    w0 = int(rng.integers(0, 3 * S1))
    valid = int(rng.integers(1, B * S1 + 1))
    lin = rng.integers(1, 1 << 20, size=w0 + valid).astype(np.int32)
    kw = dict(global_batch=B, seq_len=S, window_tok_off=w0,
              valid_limit=w0 + valid, pad_id=0)
    assert_same(ops.reassemble_window(torch.from_numpy(lin), **kw),
                jops.reassemble_window(jnp.asarray(lin), use_pallas=True, **kw),
                np_batch_oracle(lin, B, S, w0, w0 + valid))


def test_window_label_shift_exact():
    B, S = 2, 4
    lin = np.arange(100, 100 + B * (S + 1) + 1, dtype=np.int32)
    x, y = ops.reassemble_window(torch.from_numpy(lin), global_batch=B,
                                 seq_len=S)
    assert x.tolist() == [[100, 101, 102, 103], [105, 106, 107, 108]]
    assert y.tolist() == [[101, 102, 103, 104], [106, 107, 108, 109]]


@pytest.mark.parametrize("NB,T", [(6, 4), (3, 8), (1, 5)])
def test_block_gather_2d(NB, T):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 1000, size=(NB, T)).astype(np.int32)
    perm = rng.permutation(NB).astype(np.int32)
    assert_same(ops.reassemble(torch.from_numpy(src), perm),
                jops.reassemble(jnp.asarray(src), jnp.asarray(perm),
                                use_pallas=True),
                (src[perm],))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_block_gather_nd_with_repeats(dtype):
    rng = np.random.default_rng(8)
    src = (rng.standard_normal((5, 3, 4)) * 100).astype(np.float32)
    idx = np.array([4, 0, 0, 2, 4, 1], np.int32)
    tsrc = torch.from_numpy(src).to(getattr(torch, dtype))
    got = ops.reassemble(tsrc, idx)
    assert got.dtype == tsrc.dtype
    assert torch.equal(got, tsrc[torch.from_numpy(idx).long()])
    if dtype != "bfloat16":    # bf16 has no NumPy dtype to hand JAX here
        assert_same(got, jops.reassemble(jnp.asarray(tsrc.numpy()),
                                         jnp.asarray(idx), use_pallas=True))


def test_block_gather_rejects_out_of_range_host_index():
    with pytest.raises(IndexError):
        ops.reassemble(torch.zeros((3, 2), dtype=torch.int32), [0, 3])


@pytest.mark.parametrize("seed", range(4))
def test_token_gather(seed):
    rng = np.random.default_rng(200 + seed)
    B = int(rng.integers(1, 4))
    S = int(rng.integers(2, 10))
    L = int(rng.integers(B * (S + 1), 4 * B * (S + 1)))
    staged = rng.integers(0, 1000, size=L).astype(np.int32)
    row_idx = rng.integers(-1, L, size=(B, S + 1)).astype(np.int32)
    assert_same(ops.reassemble_tokens(torch.from_numpy(staged), row_idx,
                                      pad_id=9),
                jops.reassemble_tokens(jnp.asarray(staged),
                                       jnp.asarray(row_idx), pad_id=9,
                                       use_pallas=True))


@pytest.mark.parametrize("seed", range(5))
def test_device_ingest_arbitrary_arrival_order(seed):
    rng = np.random.default_rng(300 + seed)
    B = int(rng.integers(1, 4))
    S = int(rng.integers(2, 12))
    S1 = S + 1
    w0 = int(rng.integers(0, 2 * S1))
    valid = int(rng.integers(1, B * S1 + 1))
    toks = rng.integers(1, 1 << 20, size=w0 + valid).astype(np.int32)
    pieces = random_arrival_pieces(rng, 0, toks.size, 4)
    g = token_gather_from_pieces(pieces, 0, 4)
    staged = np.concatenate([toks[o // 4:o // 4 + nb // 4] for o, nb in pieces])
    kw = dict(global_batch=B, seq_len=S, window_tok_off=w0, valid_tokens=valid)
    assert_same(ops.device_ingest(torch.from_numpy(staged), g, **kw),
                jops.device_ingest(jnp.asarray(staged), g, use_pallas=True,
                                   **kw),
                np_batch_oracle(toks, B, S, w0, w0 + valid))


def test_device_ingest_block_permutation_path():
    rng = np.random.default_rng(9)
    T, NB, B, S = 8, 6, 4, 11   # NB*T = 48 = B*(S+1) tokens
    toks = rng.integers(1, 1000, size=NB * T).astype(np.int32)
    perm = rng.permutation(NB).astype(np.int32)
    pieces = [(int(f) * T * 4, T * 4) for f in np.argsort(perm)]
    g = token_gather_from_pieces(pieces, 0, 4)
    assert as_block_permutation(g, T) is not None
    staged = toks.reshape(NB, T)[np.argsort(perm)].reshape(-1)
    kw = dict(global_batch=B, seq_len=S, block_tokens=T)
    assert_same(ops.device_ingest(torch.from_numpy(staged), g, **kw),
                jops.device_ingest(jnp.asarray(staged), g, use_pallas=True,
                                   **kw),
                np_batch_oracle(toks, B, S))


# -- tests/test_streaming.py cases ------------------------------------------------

def _random_chunks(rng, toks):
    n = toks.size
    ncuts = int(rng.integers(0, min(7, n - 1) + 1))
    cuts = (np.sort(rng.choice(np.arange(1, n), size=ncuts, replace=False))
            if ncuts else np.array([], int))
    bounds = [0, *cuts.tolist(), n]
    return [toks[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]


@pytest.mark.parametrize("seed", range(6))
def test_ingest_chunks_window(seed):
    rng = np.random.default_rng(400 + seed)
    B = int(rng.integers(1, 4))
    S = int(rng.integers(2, 12))
    valid = int(rng.integers(1, B * (S + 1) + 1))
    toks = rng.integers(1, 1 << 20, size=valid).astype(np.int32)
    chunks = _random_chunks(rng, toks)
    kw = dict(global_batch=B, seq_len=S, valid_limit=valid)
    assert_same(ops.ingest_chunks_window([torch.from_numpy(c) for c in chunks],
                                         **kw),
                jops.ingest_chunks_window([jnp.asarray(c) for c in chunks],
                                          use_pallas=True, **kw),
                np_batch_oracle(toks, B, S, 0, valid))


@pytest.mark.parametrize("seed", range(6))
def test_block_unpermute_then_window(seed):
    """``ingest_chunks_block``'s layout: arrival-ordered uniform blocks,
    unpermuted by the block gather, then the window reassembly."""
    rng = np.random.default_rng(500 + seed)
    T = int(rng.integers(2, 9))
    NB = int(rng.integers(2, 9))
    B, S = 2, NB * T // 2 - 1
    if S < 1:
        B, S = 1, NB * T - 1
    toks = rng.integers(1, 1 << 20, size=NB * T).astype(np.int32)
    staged_order = rng.permutation(NB)
    chunks = [toks[b * T:(b + 1) * T] for b in staged_order]
    perm = np.empty(NB, dtype=np.int32)
    for i, b in enumerate(staged_order):
        perm[b] = i
    staged = torch.from_numpy(np.concatenate(chunks))
    linear = ops.reassemble(staged.reshape(NB, T), perm).reshape(-1)
    got = ops.reassemble_window(linear, global_batch=B, seq_len=S)
    assert_same(got,
                jops.ingest_chunks_block([jnp.asarray(c) for c in chunks],
                                         jnp.asarray(perm), global_batch=B,
                                         seq_len=S, use_pallas=True),
                np_batch_oracle(toks, B, S))


def test_token_gather_over_chunks():
    rng = np.random.default_rng(7)
    B, S, L = 2, 5, 40
    toks = rng.integers(0, 1000, size=L).astype(np.int32)
    row_idx = rng.integers(-1, L, size=(B, S + 1)).astype(np.int32)
    chunks = [jnp.asarray(toks[:13]), jnp.asarray(toks[13:27]),
              jnp.asarray(toks[27:])]
    assert_same(ops.reassemble_tokens(torch.from_numpy(toks), row_idx,
                                      pad_id=9),
                jops.ingest_chunks_tokens(chunks, jnp.asarray(row_idx),
                                          pad_id=9, use_pallas=True))


# -- dispatch ---------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_path():
    K.reset_launch_counts()
    lin = torch.arange(20, dtype=torch.int32)
    ops.reassemble_window(lin, global_batch=2, seq_len=3)
    ops.reassemble(lin.reshape(4, 5), [1, 0])
    ops.reassemble_tokens(lin, np.zeros((2, 4), np.int32))
    assert K.LAUNCHES == {"reassemble_window": 0, "reassemble": 0,
                          "reassemble_tokens": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    lin = torch.arange(20, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.reassemble_window_cuda([lin], global_batch=2, seq_len=3)
    with pytest.raises(ValueError):
        K.reassemble_cuda(lin.reshape(4, 5), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.reassemble_tokens_cuda(lin, torch.zeros((2, 4), dtype=torch.int32))


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        ops._on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
