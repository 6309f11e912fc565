"""Sequence packing / label construction for LM training batches.

Also home of the **device-ingest index maps**: the arrival-order →
consumer-order permutation the CkIO paper performs in host DRAM (phase 2,
§V-B) is described here as a NumPy index map built from ``io/layout.py``
piece plans, then *executed on device* by ``kernels/reassemble.py``. The map
construction is pure and property-tested; the hot path builds it once per
step from host metadata (never touching token bytes).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def window_rows(step: int, global_batch: int, seq_len: int) -> Tuple[int, int]:
    """Token rows needed for training step ``step``.

    Each step consumes ``global_batch`` sequences of ``seq_len + 1`` tokens
    (inputs + shifted labels share the window). Returns (start_row, num_rows).
    """
    rows_per_step = global_batch * (seq_len + 1)
    return step * rows_per_step, rows_per_step


def batch_from_tokens(
    tokens: np.ndarray,
    global_batch: int,
    seq_len: int,
    *,
    allow_partial: bool = False,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat token window -> (inputs, labels), both (global_batch, seq_len).

    ``allow_partial=True`` pads a short final window with ``pad_id`` (one
    host copy, remainder windows only); the full-window path stays
    zero-copy.
    """
    need = global_batch * (seq_len + 1)
    if tokens.size < need:
        if not allow_partial:
            raise ValueError(f"window too small: {tokens.size} < {need}")
        padded = np.full(need, pad_id, dtype=tokens.dtype)
        padded[: tokens.size] = tokens
        tokens = padded
    seqs = tokens[:need].reshape(global_batch, seq_len + 1)
    # views, not copies: device_put handles strided arrays, and the extra
    # 2x window copies measurably serialize the host pipeline on weak hosts
    return seqs[:, :-1], seqs[:, 1:]


def pack_documents(
    doc_tokens: list, seq_len: int, eos_id: int, pad_id: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy document packing into fixed-length rows with segment ids.

    Returns (packed (N, seq_len), segment_ids (N, seq_len)). Segment ids
    let attention mask out cross-document positions; unused slots get
    segment id 0 (= padding).
    """
    rows, segs = [], []
    cur, cur_seg, seg_idx = [], [], 1
    for doc in doc_tokens:
        toks = list(doc) + [eos_id]
        while toks:
            space = seq_len - len(cur)
            take = toks[:space]
            cur.extend(take)
            cur_seg.extend([seg_idx] * len(take))
            toks = toks[space:]
            if len(cur) == seq_len:
                rows.append(cur)
                segs.append(cur_seg)
                cur, cur_seg = [], []
                seg_idx += 1 if toks else 0
        seg_idx += 1
    if cur:
        pad = seq_len - len(cur)
        rows.append(cur + [pad_id] * pad)
        segs.append(cur_seg + [0] * pad)
    return np.asarray(rows, dtype=np.int32), np.asarray(segs, dtype=np.int32)


def token_gather_from_pieces(
    pieces: Sequence[Tuple[int, int]],
    session_abs_off: int,
    itemsize: int,
) -> np.ndarray:
    """Arrival-order→file-order token index map from a piece plan.

    ``pieces`` is ``[(abs_off, nbytes), ...]`` in **arrival (staged) order**
    — e.g. ``zip(plan.splinters, session.arrival_order)`` or coalesced
    pieces from ``pieces_for_range`` — jointly covering the session
    ``[session_abs_off, session_abs_off + sum(nbytes))`` exactly once. The
    staged buffer is their concatenation in that order.

    Returns ``g`` (int32, one entry per session token): ``g[p]`` is the
    staged position of file-order token ``p``, i.e. ``staged[g] ==
    session_tokens``. Raises ``ValueError`` on overlap, gaps, or byte
    ranges not aligned to ``itemsize``.
    """
    total = sum(nb for _, nb in pieces)
    if total % itemsize:
        raise ValueError(f"pieces cover {total} bytes, not a multiple of "
                         f"itemsize {itemsize}")
    num_tokens = total // itemsize
    g = np.full(num_tokens, -1, dtype=np.int64)
    staged_pos = 0
    for abs_off, nbytes in pieces:
        if abs_off % itemsize or nbytes % itemsize:
            raise ValueError(
                f"piece [{abs_off}, {abs_off + nbytes}) not aligned to "
                f"itemsize {itemsize}")
        t0 = (abs_off - session_abs_off) // itemsize
        nt = nbytes // itemsize
        if t0 < 0 or t0 + nt > num_tokens:
            raise ValueError(
                f"piece [{abs_off}, {abs_off + nbytes}) outside session")
        if np.any(g[t0 : t0 + nt] >= 0):
            raise ValueError("overlapping pieces in arrival plan")
        g[t0 : t0 + nt] = staged_pos + np.arange(nt, dtype=np.int64)
        staged_pos += nt
    if np.any(g < 0):  # pragma: no cover - overlap+total checks imply this
        raise ValueError("piece plan leaves session gaps")
    return g.astype(np.int32)


def as_block_permutation(
    g: np.ndarray, block_tokens: int
) -> Optional[np.ndarray]:
    """Recognize a token gather map as a uniform block permutation.

    If ``g`` (from ``token_gather_from_pieces``) satisfies
    ``g[p] = perm[p // T] * T + p % T`` for ``T = block_tokens`` — i.e. the
    staged buffer is a permutation of equal ``T``-token blocks — return
    ``perm`` (int32, file-order block → staged block), which is exactly the
    scalar-prefetch operand of the block-gather kernel. Return ``None``
    when the layout is not block-uniform (the token-level path applies).
    """
    n = g.shape[0]
    T = block_tokens
    if T <= 0 or n % T:
        return None
    blocks = g.reshape(n // T, T)
    base = blocks[:, 0]
    if np.any(base % T):
        return None
    if np.any(blocks != base[:, None] + np.arange(T, dtype=g.dtype)[None, :]):
        return None
    return (base // T).astype(np.int32)


def row_gather_index(
    g: np.ndarray,
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_tokens: Optional[int] = None,
) -> np.ndarray:
    """Per-row token index map for ``reassemble_tokens_pallas``.

    ``g`` maps file-order session tokens to staged positions; the window
    starts ``window_tok_off`` tokens into the session and holds
    ``valid_tokens`` real tokens (≤ ``global_batch * (seq_len + 1)``;
    remainder final windows). Returns ``(B, S+1)`` int32 — entry
    ``[b, j]`` is the staged position of window flat token
    ``b*(S+1) + j``, or ``-1`` where the window (or session) ends.
    Column ``S`` (the row's last token) only feeds the shifted labels.
    """
    B, S = global_batch, seq_len
    S1 = S + 1
    if valid_tokens is None:
        valid_tokens = B * S1
    flat = (window_tok_off
            + np.arange(B, dtype=np.int64)[:, None] * S1
            + np.arange(S1, dtype=np.int64)[None, :])
    ok = (flat < window_tok_off + valid_tokens) & (flat < g.shape[0])
    out = np.full(flat.shape, -1, dtype=np.int32)
    out[ok] = g[flat[ok]]
    return out


def pieces_in_arrival_order(
    splinters, arrival_order: Sequence[int]
) -> List[Tuple[int, int]]:
    """``(abs_off, nbytes)`` pieces for a session staged by splinter arrival.

    ``splinters`` is ``plan.splinters`` (file order, indexed by global
    splinter id); ``arrival_order`` is ``session.arrival_order`` — the
    completion order the reader layer records. The result feeds
    ``token_gather_from_pieces``.
    """
    by_index = {s.index: s for s in splinters}
    return [(by_index[i].offset, by_index[i].nbytes) for i in arrival_order]
