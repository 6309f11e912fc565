"""Public entry points for on-device batch reassembly and attention.

Dispatch is by the device of the tensors: CUDA tensors go to the
hand-written kernels in ``kernels/reassemble.py`` and
``kernels/flash_attention.py`` (which raise if they cannot launch), CPU
tensors to the plain PyTorch versions in ``kernels/ref.py``. There is no
fallback from one to the other. Host metadata (index maps from
``data/packing.py``) may be passed as NumPy arrays; it is checked on the
host and uploaded next to the data.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.packing import as_block_permutation, row_gather_index
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import reassemble as K


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on unsupported or mixed devices: "
                     f"{sorted(kinds)}")


def _index(idx, device: torch.device, upper: int | None = None) -> torch.Tensor:
    """int32 index tensor on ``device``; host indices are range-checked
    against ``[0, upper)`` before upload when ``upper`` is given."""
    if isinstance(idx, torch.Tensor) and idx.device.type == "cuda":
        return idx
    host = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    if upper is not None and host.size and (host.min() < 0 or host.max() >= upper):
        raise IndexError(f"block index out of range [0, {upper})")
    return torch.from_numpy(np.ascontiguousarray(host, dtype=np.int32)).to(device)


def flash_attention(
    q: torch.Tensor,              # (B, Sq, H, hd)
    k: torch.Tensor,              # (B, Sk, K, hd)
    v: torch.Tensor,              # (B, Sk, K, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Attention in the reference's ``(B, S, H, hd)`` layout; returns
    ``(B, Sq, H, hd)``. The CUDA kernel reads the inputs through their
    strides (views such as a cache prefix need no copy). A window without
    a causal mask is refused: the reference's Pallas kernel and its oracle
    disagree there, and no caller uses it."""
    if window > 0 and not causal:
        raise ValueError("flash_attention: window > 0 needs causal=True")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _on_cuda(q, k, v):
        out = FA.flash_attention_cuda(qt, kt, vt, causal=causal, window=window)
    else:
        out = ref.attention_ref(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)


def reassemble(src: torch.Tensor, idx) -> torch.Tensor:
    """Block gather ``out[i] = src[idx[i]]`` over the leading axis."""
    idx = _index(idx, src.device, src.shape[0])
    if _on_cuda(src):
        return K.reassemble_cuda(src, idx)
    return ref.reassemble_ref(src, idx)


def reassemble_window(
    linear: torch.Tensor,
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_limit: int | None = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """File-order token buffer -> batch-major (inputs, labels) on device."""
    return ingest_chunks_window(
        [linear], global_batch=global_batch, seq_len=seq_len,
        window_tok_off=window_tok_off, valid_limit=valid_limit, pad_id=pad_id)


def reassemble_tokens(staged: torch.Tensor, row_idx, *, pad_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level gather (non-block-uniform staged layouts)."""
    row_idx = _index(row_idx, staged.device)
    if _on_cuda(staged):
        return K.reassemble_tokens_cuda(staged, row_idx, pad_id=pad_id)
    return ref.tokens_gather_ref(staged, row_idx, pad_id=pad_id)


def ingest_chunks_window(
    chunks: Sequence[torch.Tensor],
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_limit: int | None = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """File-order chunk list -> (inputs, labels). On CUDA the kernel reads
    the chunks in place through a pointer table (no concatenation); the
    plain version concatenates first."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("ingest_chunks_window: no chunks")
    kw = dict(global_batch=global_batch, seq_len=seq_len,
              window_tok_off=window_tok_off, valid_limit=valid_limit,
              pad_id=pad_id)
    if _on_cuda(*chunks):
        return K.reassemble_window_cuda(chunks, **kw)
    return ref.window_chunks_ref(chunks, **kw)


def device_ingest(
    staged: torch.Tensor,         # (L,) staged tokens on device
    gather=None,                  # np.ndarray token map or None (file order)
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_tokens: int | None = None,
    pad_id: int = 0,
    block_tokens: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-transfer device reassembly: staged tokens -> (inputs, labels).

    ``gather`` (host NumPy, from ``data.packing.token_gather_from_pieces``)
    describes the staged layout: ``None`` means file order (the pipeline's
    whole-window arena view), otherwise it is the arrival-order→file-order
    token map. Layout dispatch happens on host metadata only:

    * file order        -> window kernel directly;
    * block permutation -> block-gather unpermute, then window kernel;
    * anything else     -> token-level gather kernel.
    """
    S1 = seq_len + 1
    if valid_tokens is None:
        valid_tokens = global_batch * S1
    valid_limit = window_tok_off + valid_tokens
    kw = dict(global_batch=global_batch, seq_len=seq_len,
              window_tok_off=window_tok_off, valid_limit=valid_limit,
              pad_id=pad_id)
    if gather is None:
        return reassemble_window(staged, **kw)
    perm = (as_block_permutation(gather, block_tokens)
            if block_tokens else None)
    if perm is not None:
        T = block_tokens
        blocks = staged[: perm.shape[0] * T].reshape(perm.shape[0], T)
        linear = reassemble(blocks, perm).reshape(-1)
        return reassemble_window(linear, **kw)
    row_idx = row_gather_index(
        gather, global_batch=global_batch, seq_len=seq_len,
        window_tok_off=window_tok_off, valid_tokens=valid_tokens)
    return reassemble_tokens(staged, row_idx, pad_id=pad_id)
