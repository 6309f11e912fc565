"""RG-LRU linear recurrence for Hopper: bind and launch.

``csrc/rglru_scan.cu`` holds the kernel (what it replaces, what bounds it
and its design are noted there). It is built at first launch by the
package's builder (``kernels/reassemble.py``: ``nvcc`` for ``sm_90a`` into
the build directory, loaded with ``ctypes``), never at import.

The wrapper takes fp32 contiguous ``a``/``b`` ``(B, S, W)`` and an optional
initial state ``h0`` ``(B, W)``. It checks device, dtype, rank, shape and
contiguity and raises on anything else (no copy, no other route),
allocates ``h`` ``(B, S, W)`` with ``torch.empty``, launches on the current
stream, raises if the launcher reports a CUDA error and adds one to
:data:`LAUNCHES`. The plain version of the same function is
``kernels/ref.py``'s ``lru_scan_ref``. The kernel is forward-only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import reassemble as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
FORWARD_ONLY = (
    "rglru_scan: the CUDA RG-LRU kernel is forward-only (the reference has "
    "no backward kernel either); training a recurrent model on the card "
    "comes with its own slice (ROADMAP.md, Queue A item 9)")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"rglru_scan": 0}


def reset_launch_counts() -> None:
    LAUNCHES["rglru_scan"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, L = ctypes.c_void_p, ctypes.c_longlong
    lib.ckio_rglru_scan.argtypes = [P, P, P, P, L, L, L, P]
    lib.ckio_rglru_scan.restype = ctypes.c_int


def rglru_scan_cuda(
    a: torch.Tensor,                    # (B, S, W) fp32
    b: torch.Tensor,                    # (B, S, W) fp32
    *,
    h0: Optional[torch.Tensor] = None,  # (B, W) fp32
) -> torch.Tensor:
    """Every ``h`` (B, S, W); ``h[:, -1]`` is the final state."""
    named = {"a": a, "b": b}
    if h0 is not None:
        named["h0"] = h0
    dev = a.device
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"rglru_scan: every input must be on one CUDA "
                             f"device ({name} is on {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan: {name} must be float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan: {name} must be contiguous")
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a must be (B, S, W), got "
                         f"{tuple(a.shape)}")
    B, S, W = a.shape
    if tuple(b.shape) != (B, S, W):
        raise ValueError(f"rglru_scan: b {tuple(b.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} is not {(B, W)}")
    h = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    if h.numel() == 0:
        return h
    rc = _build.load_library(SOURCE, _bind).ckio_rglru_scan(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), B, S, W, _build.stream_of(h))
    _build.check_rc(rc, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h
