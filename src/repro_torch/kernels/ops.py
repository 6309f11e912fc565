"""Public entry points for on-device batch reassembly, attention, the
selective scan and the RG-LRU recurrence (each literal, as the reference's
Pallas function, and fused with the layer's elementwise work around it).

Dispatch is by the device of the tensors: CUDA tensors go to the
hand-written kernels in ``kernels/reassemble.py``,
``kernels/flash_attention.py``, ``kernels/mamba_scan.py`` and
``kernels/rglru_scan.py`` (which raise if they cannot launch), CPU
tensors to the plain PyTorch versions in ``kernels/ref.py``. There is no
fallback from one to the other. ``flash_attention_train``,
``mamba_scan``, ``mamba_scan_fused`` and ``rglru_scan_gated`` are
differentiable: where autograd needs their gradient they run through a
``torch.autograd.Function`` whose backward is a hand-written kernel on the
card and a plain backward on the CPU; ``flash_attention`` and the literal
``rglru_scan``, which no path differentiates, raise there. The five
other compute entries also take meta tensors (the dry run's,
``launch/dryrun.py``): those go to the
``ckio_meta`` ops of ``kernels/meta.py``, which give shapes, FLOPs and a
DTensor sharding rule and run nothing; the check is one attribute read,
ahead of the CUDA and CPU dispatch, which is unchanged. Host metadata
(index maps from ``data/packing.py``) may be passed as NumPy arrays; it is
checked on the host and uploaded next to the data.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.packing import as_block_permutation, row_gather_index
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as LRU
from repro_torch.kernels import reassemble as K


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on unsupported or mixed devices: "
                     f"{sorted(kinds)}")


def _needs_grad(ins) -> bool:
    """Whether autograd would need a gradient through a call on ``ins``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ins)


def _forward_only(ins, msg: str) -> None:
    """Raise ``msg`` where autograd would need a gradient through a
    forward-only kernel."""
    if _needs_grad(ins):
        raise NotImplementedError(msg)


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
    softcap: float = 0.0,
) -> torch.Tensor:
    """Attention in the reference's ``(B, S, H, hd)`` layout; returns
    ``(B, Sq, H, hd)``. The CUDA kernel reads the inputs through their
    strides (views such as a cache prefix need no copy). A window without
    a causal mask is refused: the reference's Pallas kernel and its oracle
    disagree there, and no caller uses it. ``softcap > 0`` caps the scaled
    scores (``softcap * tanh(s / softcap)``, the reference's ``_sdpa``); on
    the card only the decode path computes it (``FA.launch_plan``), and a
    capped call that would take a prefill path raises ``ValueError``."""
    if window > 0 and not causal:
        raise ValueError("flash_attention: window > 0 needs causal=True")
    if softcap < 0.0:
        raise ValueError(f"flash_attention: softcap {softcap} < 0")
    if q.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.flash_attention(q, k, v, causal=causal, window=window)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if _on_cuda(q, k, v):
        _forward_only((q, k, v), FA.FORWARD_ONLY)
        out = FA.flash_attention_cuda(qt, kt, vt, causal=causal, window=window,
                                      softcap=softcap)
    else:
        out = ref.attention_ref(qt, kt, vt, causal=causal, window=window,
                                softcap=softcap)
    return out.transpose(1, 2)


def flash_attention_train(
    q: torch.Tensor,              # (B, S, H, hd)
    k: torch.Tensor,              # (B, S, K, hd)
    v: torch.Tensor,              # (B, S, K, hd)
    *,
    window: int = 0,
) -> torch.Tensor:
    """Causal attention (with ``window`` > 0, a sliding window too) in the
    ``(B, S, H, hd)`` layout, differentiable (``FA.FlashAttentionTrainFn``):
    on the card the training forward keeps each row's log-sum-exp for the
    backward kernels, and the score tensor is never written; on the CPU the
    plain versions. The card takes bf16 and hd in ``FA.TRAIN_HEAD_DIMS``;
    ``models/attention.py`` routes what it cannot take to ``_sdpa``."""
    return FA.FlashAttentionTrainFn.apply(_on_cuda(q, k, v), q, k, v,
                                          int(window))


def mamba_scan(
    Abar: torch.Tensor,                   # (B, S, D, N) fp32
    Bx: torch.Tensor,                     # (B, S, D, N) fp32
    C: torch.Tensor,                      # (B, S, N) fp32
    *,
    h0: Optional[torch.Tensor] = None,    # (B, D, N) fp32
    return_state: bool = False,
):
    """The Mamba-1 selective scan: ``y`` (B, S, D), or ``(y, h_S)`` with
    ``return_state``. With ``h0=None`` it is the reference's
    ``mamba_scan_pallas``; a decode step passes its carried state as ``h0``
    with S = 1. Differentiable (``MS.MambaScanFn``): on the card the
    backward is ``scan_bwd_kernel``; a gradient through ``h_S`` raises."""
    if Abar.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.mamba_scan(Abar, Bx, C, h0=h0, return_state=return_state)
    ins = (Abar, Bx, C) if h0 is None else (Abar, Bx, C, h0)
    cuda = _on_cuda(*ins)
    if _needs_grad(ins):
        y, h = MS.MambaScanFn.apply(cuda, Abar, Bx, C, h0, return_state)
    elif cuda:
        y, h = MS.mamba_scan_cuda(Abar, Bx, C, h0=h0,
                                  return_state=return_state)
    else:
        y, h = ref.ssm_scan_ref(Abar, Bx, C, h0, return_state=True)
    return (y, h) if return_state else y


def rglru_scan(
    a: torch.Tensor,                      # (B, S, W) fp32
    b: torch.Tensor,                      # (B, S, W) fp32
    *,
    h0: Optional[torch.Tensor] = None,    # (B, W) fp32
) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t``: every ``h``
    (B, S, W). With ``h0=None`` it is the reference's
    ``rglru_scan_pallas``; a decode step passes its carried state as ``h0``
    with S = 1. The CUDA kernel is forward-only (:data:`LRU.FORWARD_ONLY`):
    no path differentiates it, since every RG-LRU layer runs the gated
    entry; the plain version on CPU tensors is differentiable."""
    if a.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.rglru_scan(a, b, h0=h0)
    ins = (a, b) if h0 is None else (a, b, h0)
    if _on_cuda(*ins):
        _forward_only(ins, LRU.FORWARD_ONLY)
        return LRU.rglru_scan_cuda(a, b, h0=h0)
    return ref.lru_scan_ref(a, b, h0)


def mamba_scan_fused(
    xin: torch.Tensor,                    # (B, S, D) compute dtype
    dt_pre: torch.Tensor,                 # (B, S, D) compute dtype
    dt_bias: torch.Tensor,                # (D,) fp32
    A_log: torch.Tensor,                  # (D, N) fp32
    proj: torch.Tensor,                   # (B, S, r+2N) compute dtype
    Dskip: torch.Tensor,                  # (D,) fp32
    z: torch.Tensor,                      # (B, S, D) compute dtype
    *,
    h0: Optional[torch.Tensor] = None,    # (B, D, N) fp32
    return_state: bool = False,
):
    """A Mamba-1 layer from the conv output to the gated output, ``y``
    (B, S, D) in the compute dtype, or ``(y, h_S)`` with ``return_state``:
    ``dt = softplus(dt_pre + dt_bias)``, ``Abar = exp(dt A)``, ``Bx = dt Bc
    xin``, the selective scan read out with ``Cc``, then ``(y + D xin) *
    silu(z)``; ``Bc``/``Cc`` are the last 2N columns of ``proj``. The
    reference's ``_fused_chunk_scan`` plus its skip and gate. Views (``z``
    of ``xz``, ``proj``'s columns) are read through their strides.
    Differentiable (``MS.MambaScanFusedFn``): on the card the backward is
    ``fused_bwd_kernel`` with torch's skip, gate and softplus derivatives
    around it; a gradient through ``h_S`` raises."""
    if xin.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.mamba_scan_fused(xin, dt_pre, dt_bias, A_log, proj, Dskip,
                                     z, h0=h0, return_state=return_state)
    args = (xin, dt_pre, dt_bias, A_log, proj, Dskip, z)
    ins = args if h0 is None else (*args, h0)
    cuda = _on_cuda(*ins)
    if _needs_grad(ins):
        y, h = MS.MambaScanFusedFn.apply(cuda, *args, h0, return_state)
    elif cuda:
        y, h = MS.mamba_scan_fused_cuda(*args, h0=h0,
                                        return_state=return_state)
    else:
        y, h = ref.mamba_scan_fused_ref(*args, h0, return_state=True)
    return (y, h) if return_state else y


def rglru_scan_gated(
    r_pre: torch.Tensor,                  # (B, S, W) fp32
    i_pre: torch.Tensor,                  # (B, S, W) fp32
    b_r: torch.Tensor,                    # (W,) fp32
    b_i: torch.Tensor,                    # (W,) fp32
    lam: torch.Tensor,                    # (W,) fp32
    xr: torch.Tensor,                     # (B, S, W) compute dtype
    gate: torch.Tensor,                   # (B, S, W) compute dtype
    *,
    h0: Optional[torch.Tensor] = None,    # (B, W) fp32
    return_state: bool = False,
):
    """An RG-LRU layer from the two gate products to the gated output:
    ``y = h.to(dtype) * gate`` (B, S, W), or ``(y, h_S)`` with
    ``return_state``, where ``h`` is the recurrence with ``a = exp(-8
    softplus(lam) sigmoid(r_pre + b_r))`` and input ``sqrt(1 - a^2)
    sigmoid(i_pre + b_i) xr``. ``xr`` and ``gate`` are read through their
    strides. Differentiable (``LRU.RGLRUScanGatedFn``): on the card the
    backward is ``lru_bwd_kernel``; a gradient through ``h_S`` raises."""
    if r_pre.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.rglru_scan_gated(r_pre, i_pre, b_r, b_i, lam, xr, gate,
                                     h0=h0, return_state=return_state)
    args = (r_pre, i_pre, b_r, b_i, lam, xr, gate)
    ins = args if h0 is None else (*args, h0)
    cuda = _on_cuda(*ins)
    if _needs_grad(ins):
        y, h = LRU.RGLRUScanGatedFn.apply(cuda, *args, h0, return_state)
    elif cuda:
        y, h = LRU.rglru_scan_gated_cuda(*args, h0=h0,
                                         return_state=return_state)
    else:
        y, h = ref.rglru_scan_gated_ref(*args, h0, return_state=True)
    return (y, h) if return_state else y


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


def staged_concat(chunks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate streamed staging chunks into one device-resident buffer:
    the arrival-ordered staged layout the gather index maps describe (the
    contiguous buffer of the reference's multi-host layout). One chunk
    is returned as it is."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("staged_concat: no chunks")
    if len(chunks) == 1:
        return chunks[0]
    return torch.cat(chunks)


def ingest_chunks_block(
    chunks: Sequence[torch.Tensor],
    perm,                         # (NB,) file-order block -> staged block
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_limit: int | None = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform-block arrival-order chunks -> (inputs, labels): the
    concatenation, the block unpermute (``reassemble``) and the window
    kernel, as the reference composes them."""
    staged = staged_concat(chunks)
    nb = perm.shape[0]
    T = staged.shape[0] // nb
    linear = reassemble(staged[: nb * T].reshape(nb, T), perm).reshape(-1)
    return reassemble_window(
        linear, global_batch=global_batch, seq_len=seq_len,
        window_tok_off=window_tok_off, valid_limit=valid_limit, pad_id=pad_id)


def ingest_chunks_tokens(chunks: Sequence[torch.Tensor], row_idx, *,
                         pad_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-uniform arrival-order chunks -> (inputs, labels): the
    concatenation, then the token-level gather."""
    return reassemble_tokens(staged_concat(chunks), row_idx, pad_id=pad_id)


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
