"""Flash-attention forward for Hopper: bind and launch.

``csrc/flash_attention.cu`` holds the kernel (what it replaces, what bounds
it and its design are noted there). It is built at first launch by the
package's builder (``kernels/reassemble.py``: ``nvcc`` for ``sm_90a`` into
the build directory, loaded with ``ctypes``), never at import.

The wrapper takes q ``(B, H, Sq, hd)`` and k/v ``(B, K, Sk, hd)`` as views
with any strides, so ``ops.flash_attention`` passes the ``(B, S, H, hd)``
activations and a ``(B, C, K, hd)`` cache prefix in place (no transposed
copy). It checks device, dtype, rank and head size, allocates the output
with ``torch.empty``, launches on the current stream, raises if the
launcher reports a CUDA error and adds one to :data:`LAUNCHES`. The plain
version of the same function is ``kernels/ref.py``'s ``attention_ref``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import reassemble as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ckio_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I,
                                         ctypes.c_double, P]
    lib.ckio_flash_attention.restype = ctypes.c_int


def flash_attention_cuda(
    q: torch.Tensor,               # (B, H, Sq, hd), any strides
    k: torch.Tensor,               # (B, K, Sk, hd)
    v: torch.Tensor,               # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Online-softmax attention on the card; returns a ``(B, H, Sq, hd)``
    view of a ``(B, Sq, H, hd)`` contiguous tensor in q's dtype."""
    dev = q.device
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("flash_attention: q, k, v must be on one CUDA "
                             f"device (got {q.device}, {k.device}, {v.device})")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: 4-D inputs expected, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError("flash_attention: q, k, v must share a dtype")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if tuple(k.shape) != (B, K, Sk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {H} query heads over {K} kv heads")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    dims = (ctypes.c_longlong * 21)(
        B, H, K, Sq, Sk, *q.stride(), *k.stride(), *v.stride(), *out.stride())
    rc = _build.load_library(SOURCE, _bind).ckio_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims,
        _DTYPE_CODES[q.dtype], hd, int(bool(causal)), int(window),
        hd ** -0.5, _build.stream_of(out))
    _build.check_rc(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
