"""The staged-chunk ops of the port (``ops.staged_concat``,
``ingest_chunks_block``, ``ingest_chunks_tokens``) against the reference's,
whose Pallas kernels run in interpret mode, over arrival-ordered chunks:
uniform blocks in a shuffled order, and splinter pieces of arbitrary sizes
through the token map, with window offsets, valid limits and pads. Tokens
are compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data.packing import row_gather_index as jrow_gather_index  # noqa: E402
from repro.data.packing import token_gather_from_pieces as jgather  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.data.packing import row_gather_index, token_gather_from_pieces  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402


def _same(port, ref):
    for p, j in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_staged_concat(n):
    rng = np.random.default_rng(n)
    chunks = [rng.integers(0, 1 << 20, size=int(rng.integers(1, 9)))
              .astype(np.int32) for _ in range(n)]
    got = ops.staged_concat([torch.from_numpy(c) for c in chunks])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.staged_concat(
            [jnp.asarray(c) for c in chunks])))
    if n == 1:
        one = torch.from_numpy(chunks[0])
        assert ops.staged_concat([one]) is one
    with pytest.raises(ValueError, match="no chunks"):
        ops.staged_concat([])


@pytest.mark.parametrize("seed", range(6))
def test_ingest_chunks_block(seed):
    """Uniform blocks staged in a shuffled arrival order (one chunk each,
    or a few blocks a chunk), unpermuted and reassembled, with a window
    offset, a valid limit and a pad on half the cases."""
    rng = np.random.default_rng(600 + seed)
    T = int(rng.integers(2, 9))
    NB = int(rng.integers(3, 12))
    toks = rng.integers(1, 1 << 20, size=NB * T).astype(np.int32)
    order = rng.permutation(NB)
    perm = np.empty(NB, dtype=np.int32)
    perm[order] = np.arange(NB, dtype=np.int32)
    staged = np.concatenate([toks[b * T:(b + 1) * T] for b in order])
    cuts = np.sort(rng.choice(np.arange(1, NB), size=min(2, NB - 1),
                              replace=False)) * T
    chunks = np.split(staged, cuts) if seed % 2 else np.split(staged, NB)
    w0 = int(rng.integers(0, T)) if seed % 3 else 0
    S = int(rng.integers(1, (NB * T - w0) // 2))
    Bt = max(1, (NB * T - w0) // (S + 1))
    kw = dict(global_batch=Bt, seq_len=S, window_tok_off=w0,
              valid_limit=(w0 + Bt * (S + 1) - int(rng.integers(1, S + 1))
                           if seed % 2 else None),
              pad_id=int(rng.integers(0, 9)))
    got = ops.ingest_chunks_block([torch.from_numpy(c) for c in chunks],
                                  perm, **kw)
    _same(got, jops.ingest_chunks_block([jnp.asarray(c) for c in chunks],
                                        jnp.asarray(perm), use_pallas=True,
                                        **kw))
    # the same batch as the window over the file-order tokens
    _same(got, ops.reassemble_window(torch.from_numpy(toks), **kw))
    # a tensor permutation takes the same path
    _same(ops.ingest_chunks_block([torch.from_numpy(c) for c in chunks],
                                  torch.from_numpy(perm), **kw), got)


@pytest.mark.parametrize("seed", range(6))
def test_ingest_chunks_tokens(seed):
    """Splinter pieces of arbitrary sizes in a shuffled arrival order,
    through the token map ``row_gather_index`` builds: pads past the valid
    tokens, a window offset on half the cases."""
    rng = np.random.default_rng(700 + seed)
    B, S = int(rng.integers(1, 5)), int(rng.integers(2, 40))
    w0 = int(rng.integers(0, 9)) if seed % 2 else 0
    n = w0 + B * (S + 1)
    toks = rng.integers(0, 200064, size=n).astype(np.int32)
    bounds = [0, *np.sort(rng.choice(np.arange(1, n), size=min(5, n - 1),
                                     replace=False)).tolist(), n]
    pieces = [(4 * bounds[i], 4 * (bounds[i + 1] - bounds[i]))
              for i in range(len(bounds) - 1)]
    pieces = [pieces[i] for i in rng.permutation(len(pieces))]
    chunks = [toks[o // 4:(o + nb) // 4] for o, nb in pieces]
    valid = n - w0 - (int(rng.integers(0, S)) if seed % 3 else 0)
    g = token_gather_from_pieces(pieces, 0, 4)
    np.testing.assert_array_equal(g, jgather(pieces, 0, 4))
    row_idx = row_gather_index(g, global_batch=B, seq_len=S,
                               window_tok_off=w0, valid_tokens=valid)
    np.testing.assert_array_equal(row_idx, jrow_gather_index(
        g, global_batch=B, seq_len=S, window_tok_off=w0, valid_tokens=valid))
    got = ops.ingest_chunks_tokens([torch.from_numpy(c) for c in chunks],
                                   row_idx, pad_id=5)
    _same(got, jops.ingest_chunks_tokens([jnp.asarray(c) for c in chunks],
                                         jnp.asarray(row_idx), pad_id=5,
                                         use_pallas=True))
    _same(got, ops.reassemble_window(
        torch.from_numpy(toks), global_batch=B, seq_len=S, window_tok_off=w0,
        valid_limit=w0 + valid, pad_id=5))


def test_cpu_chunks_launch_no_kernel():
    K.reset_launch_counts()
    chunks = [torch.arange(8, dtype=torch.int32),
              torch.arange(8, 16, dtype=torch.int32)]
    ops.ingest_chunks_block(chunks, np.array([1, 0, 3, 2], np.int32),
                            global_batch=1, seq_len=7)
    ops.ingest_chunks_tokens(chunks, np.zeros((2, 4), np.int32))
    assert K.LAUNCHES == {"reassemble_window": 0, "reassemble": 0,
                          "reassemble_tokens": 0}
