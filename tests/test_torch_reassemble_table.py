"""The window wrapper's host-side table work, and the port's plain
reassembly versions against the reference on arrival-ordered maps.

``reassemble.window_table`` decides where the window kernel's chunk table
goes (in the launch's parameters, or uploaded past the cap) and lays it
out as the launcher and the kernel read it; it runs on the host, so it is
held here without a card. The plain versions (``ref.window_chunks_ref``,
``ref.tokens_gather_ref``) are the oracle the CUDA kernels are held to on
the card; here they are held to ``reassemble_tokens_pallas`` (interpret
mode) and ``reassemble_window_pallas`` on token maps made of splinter runs
with pads at the splinter edges. Token movement is exact: every comparison
is bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data.packing import row_gather_index as j_row_gather_index  # noqa: E402
from repro.data.packing import token_gather_from_pieces as j_token_gather  # noqa: E402
from repro.kernels.reassemble import (  # noqa: E402
    reassemble_tokens_pallas,
    reassemble_window_pallas,
)
from repro_torch.data.packing import row_gather_index, token_gather_from_pieces  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import reassemble as K  # noqa: E402


# -- window_table: which variant, and the layout --------------------------------

CAP = 128      # kMaxParamChunks; the wrapper reads it from the built library


@pytest.mark.parametrize("n,by_value", [(1, True), (4, True), (8, True), (9, True),
                                        (127, True), (128, True),
                                        (129, False), (4100, False)])
def test_window_table_variant_by_length(n, by_value):
    tab = K.window_table(list(range(16, 16 * (n + 1), 16)), [3] * n, CAP)
    assert tab.by_value == by_value
    assert tab.total == 3 * n
    assert tab.table.dtype == np.int64


def test_window_table_layout_is_the_same_either_side_of_the_cap():
    """Only the variant moves with the cap: the launcher fills the
    by-value struct from the same array that is uploaded past it."""
    ptrs, sizes = [16, 48, 4096], [5, 0, 9]
    at, past = (K.window_table(ptrs, sizes, cap) for cap in (3, 2))
    assert at.by_value and not past.by_value
    np.testing.assert_array_equal(at.table, past.table)
    assert at.total == past.total == 14


@pytest.mark.parametrize("n", [1, 5, 8, 9, 100, 128, 129, 1000])
def test_window_table_layout(n):
    """``n`` pointers in chunk order, then the ``n + 1`` prefix token
    offsets, 8 bytes each, at the cap and past it."""
    rng = np.random.default_rng(n)
    ptrs = (rng.integers(1, 1 << 40, size=n) * 16).tolist()
    sizes = rng.integers(0, 5000, size=n).tolist()
    tab = K.window_table(ptrs, sizes, CAP)
    assert tab.by_value == (n <= CAP)
    assert tab.table.shape == (2 * n + 1,)
    assert tab.table.nbytes == 8 * (2 * n + 1)
    assert tab.table[:n].tolist() == ptrs
    starts = np.concatenate([[0], np.cumsum(sizes)])
    np.testing.assert_array_equal(tab.table[n:], starts)
    assert tab.total == int(starts[-1])


def test_window_table_refuses_mismatched_or_empty_tables():
    with pytest.raises(ValueError):
        K.window_table([], [], CAP)
    with pytest.raises(ValueError):
        K.window_table([16, 32], [1], CAP)


def test_reset_clears_table_uploads():
    K.TABLE_UPLOADS = 3
    K.reset_launch_counts()
    assert K.TABLE_UPLOADS == 0


def test_window_wrapper_refuses_a_negative_offset_before_any_launch():
    with pytest.raises(ValueError, match="window_tok_off=-1"):
        K.reassemble_window_cuda([torch.zeros(8, dtype=torch.int32)],
                                 global_batch=1, seq_len=3, window_tok_off=-1)


# -- plain versions against the reference on arrival-ordered maps ----------------

def _arrival(rng, total_tokens, splinter_tokens, itemsize=4, session_off=4096):
    """Splinter pieces of a session in a shuffled arrival order, the staged
    buffer they make, and the file tokens."""
    bounds = list(range(0, total_tokens, splinter_tokens)) + [total_tokens]
    pieces = [(session_off + bounds[i] * itemsize,
               (bounds[i + 1] - bounds[i]) * itemsize)
              for i in range(len(bounds) - 1)]
    order = rng.permutation(len(pieces))
    pieces = [pieces[i] for i in order]
    toks = rng.integers(1, 200064, size=total_tokens).astype(np.int32)
    staged = np.concatenate([toks[(o - session_off) // itemsize:
                                  (o - session_off + nb) // itemsize]
                             for o, nb in pieces])
    return pieces, staged, toks


@pytest.mark.parametrize("B,S,splinter,w0,short", [
    (2, 31, 8, 0, 0),        # runs of 8 tokens: many edges a row
    (3, 20, 7, 5, 9),        # odd runs, an offset window, a remainder
    (1, 64, 16, 3, 16),      # B = 1, the remainder ends on a splinter edge
    (4, 15, 16, 0, 1),       # S + 1 = 16: every row starts on an edge
])
def test_token_map_of_runs_matches_the_pallas_kernel(B, S, splinter, w0, short):
    """An arrival-ordered token map (runs of contiguous staged positions),
    with pads where the window's valid tokens end, and pads put at splinter
    edges: the port's plain gather against ``reassemble_tokens_pallas`` in
    interpret mode, and both against the file."""
    rng = np.random.default_rng(900 + B * S + splinter)
    n = w0 + B * (S + 1)
    pieces, staged, toks = _arrival(rng, n, splinter)
    g = token_gather_from_pieces(pieces, 4096, 4)
    np.testing.assert_array_equal(g, j_token_gather(pieces, 4096, 4))
    valid = B * (S + 1) - short
    kw = dict(global_batch=B, seq_len=S, window_tok_off=w0,
              valid_tokens=valid)
    row_idx = row_gather_index(g, **kw)
    np.testing.assert_array_equal(row_idx, j_row_gather_index(g, **kw))
    # Pads at splinter edges: the first token of every splinter after the
    # first, wherever it falls in the window.
    edge = row_idx.copy()
    flat = w0 + np.arange(B)[:, None] * (S + 1) + np.arange(S + 1)[None, :]
    edge[(flat % splinter == 0) & (flat > 0)] = -1
    for idx in (row_idx, edge):
        got = ref.tokens_gather_ref(torch.from_numpy(staged),
                                    torch.from_numpy(idx), pad_id=7)
        want = reassemble_tokens_pallas(jnp.asarray(staged), jnp.asarray(idx),
                                        pad_id=7, interpret=True)
        for p, j in zip(got, want):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    # The unpadded map gives the file's tokens up to the valid limit.
    x, y = ops.device_ingest(torch.from_numpy(staged), g, pad_id=7, **kw)
    want_x = np.where(flat[:, :S] < w0 + valid, toks[np.minimum(flat[:, :S], n - 1)], 7)
    want_y = np.where(flat[:, 1:] < w0 + valid, toks[np.minimum(flat[:, 1:], n - 1)], 7)
    np.testing.assert_array_equal(x.numpy(), want_x)
    np.testing.assert_array_equal(y.numpy(), want_y)


@pytest.mark.parametrize("B,S,splinter,w0,short", [
    (2, 31, 8, 0, 0), (3, 20, 7, 5, 9), (1, 64, 16, 3, 16), (4, 15, 16, 0, 1)])
def test_window_over_splinter_chunks_matches_the_pallas_kernel(
        B, S, splinter, w0, short):
    """The same windows as file-order splinter chunks (the streamed
    layout): the port's plain window against ``reassemble_window_pallas``
    on their concatenation, with the valid limit ending the window early."""
    rng = np.random.default_rng(950 + B * S + splinter)
    n = w0 + B * (S + 1)
    toks = rng.integers(1, 200064, size=n).astype(np.int32)
    chunks = [toks[i:i + splinter] for i in range(0, n, splinter)]
    valid_limit = n - short
    kw = dict(global_batch=B, seq_len=S, window_tok_off=w0,
              valid_limit=valid_limit, pad_id=7)
    got = ops.ingest_chunks_window([torch.from_numpy(c) for c in chunks], **kw)
    want = reassemble_window_pallas(jnp.asarray(toks), interpret=True, **kw)
    for p, j in zip(got, want):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
