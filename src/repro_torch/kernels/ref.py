"""Plain PyTorch versions of the port's kernels: the ground truth the CUDA
kernels are held to (bit-exact for the reassembly gathers, within the
stated tolerance for attention), and the path CPU tensors take."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG_INF = -2.0e38


def attention_ref(
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Dense softmax attention, GQA by head-group folding, fp32 throughout;
    the output is cast to q's dtype. Causal positions are end-aligned
    (query i sits at i + Sk - Sq); the window applies to causal masks only,
    and a row with every key masked softmaxes over the -2e38 fill (uniform
    weights), as in the reference oracle."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (hd ** -0.5)
    if causal:
        i = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        j = torch.arange(Sk, device=q.device)[None, :]
        m = j <= i
        if window > 0:
            m &= (i - j) < window
        s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def reassemble_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Block-gather: src (NB, ...), idx (NBo,) -> out (NBo, ...)."""
    return src.index_select(0, idx.to(device=src.device, dtype=torch.int64))


def window_batch_ref(
    linear: torch.Tensor,      # (L,) file-order tokens
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_limit: int | None = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused batch-major + shift: row ``b`` covers flat positions
    ``window_tok_off + b*(S+1) + j``; labels are shifted by one; positions at
    or past ``valid_limit`` (or past the buffer) read ``pad_id``."""
    B, S = global_batch, seq_len
    S1 = S + 1
    w0 = window_tok_off
    full_limit = w0 + B * S1
    if valid_limit is None:
        valid_limit = full_limit
    L = linear.shape[0]
    if L < full_limit:
        linear = torch.cat([linear, linear.new_full((full_limit - L,), pad_id)])
    seqs = linear[w0:w0 + B * S1].reshape(B, S1)
    inputs = seqs[:, :S]
    labels = seqs[:, 1:]
    if valid_limit < full_limit:
        pad = torch.tensor(pad_id, dtype=linear.dtype, device=linear.device)
        pos = (w0 + torch.arange(B, device=linear.device)[:, None] * S1
               + torch.arange(S, device=linear.device)[None, :])
        inputs = torch.where(pos < valid_limit, inputs, pad)
        labels = torch.where(pos + 1 < valid_limit, labels, pad)
    return inputs.contiguous(), labels.contiguous()


def window_chunks_ref(chunks: Sequence[torch.Tensor], **kw
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window_batch_ref`` over the concatenation of file-order chunks."""
    chunks = list(chunks)
    linear = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    return window_batch_ref(linear, **kw)


def tokens_gather_ref(
    staged: torch.Tensor, row_idx: torch.Tensor, *, pad_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token gather (``row_idx < 0`` pads; other indices clip to the buffer)."""
    S = row_idx.shape[1] - 1
    safe = row_idx.clamp(0, staged.shape[0] - 1).to(torch.int64)
    rows = staged[safe]
    pad = torch.tensor(pad_id, dtype=staged.dtype, device=staged.device)
    inputs = torch.where(row_idx[:, :S] >= 0, rows[:, :S], pad)
    labels = torch.where(row_idx[:, 1:S + 1] >= 0, rows[:, 1:S + 1], pad)
    return inputs, labels
