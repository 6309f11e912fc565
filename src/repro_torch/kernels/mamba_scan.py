"""Mamba-1 selective scan for Hopper: bind and launch.

``csrc/mamba_scan.cu`` holds the kernel (what it replaces, what bounds it
and its design are noted there). It is built at first launch by the
package's builder (``kernels/reassemble.py``: ``nvcc`` for ``sm_90a`` into
the build directory, loaded with ``ctypes``), never at import.

The wrapper takes fp32 contiguous ``Abar``/``Bx`` ``(B, S, D, N)``, ``C``
``(B, S, N)`` and an optional initial state ``h0`` ``(B, D, N)``. It checks
device, dtype, rank, shape and contiguity and raises on anything else (no
copy, no other route), allocates ``y`` ``(B, S, D)`` and, when asked, the
final state with ``torch.empty``, launches on the current stream, raises if
the launcher reports a CUDA error and adds one to :data:`LAUNCHES`. The
plain version of the same function is ``kernels/ref.py``'s
``ssm_scan_ref``. The kernel is forward-only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import reassemble as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N: a power of two, one warp at most
FORWARD_ONLY = (
    "mamba_scan: the CUDA selective-scan kernel is forward-only (the "
    "reference has no backward kernel either); training an SSM on the card "
    "comes with its own slice (ROADMAP.md, Queue A item 9)")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"mamba_scan": 0}


def reset_launch_counts() -> None:
    LAUNCHES["mamba_scan"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ckio_mamba_scan.argtypes = [P, P, P, P, P, P, L, L, L, I, P]
    lib.ckio_mamba_scan.restype = ctypes.c_int


def mamba_scan_cuda(
    Abar: torch.Tensor,                 # (B, S, D, N) fp32
    Bx: torch.Tensor,                   # (B, S, D, N) fp32
    C: torch.Tensor,                    # (B, S, N) fp32
    *,
    h0: Optional[torch.Tensor] = None,  # (B, D, N) fp32
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``y`` (B, S, D) and, with ``return_state``, the state after the last
    step (B, D, N); otherwise ``(y, None)``."""
    named = {"Abar": Abar, "Bx": Bx, "C": C}
    if h0 is not None:
        named["h0"] = h0
    dev = Abar.device
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"mamba_scan: every input must be on one CUDA "
                             f"device ({name} is on {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"mamba_scan: {name} must be float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous")
    if Abar.dim() != 4:
        raise ValueError(f"mamba_scan: Abar must be (B, S, D, N), got "
                         f"{tuple(Abar.shape)}")
    B, S, D, N = Abar.shape
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size {N} not in {STATE_SIZES}")
    if tuple(Bx.shape) != (B, S, D, N) or tuple(C.shape) != (B, S, N):
        raise ValueError(f"mamba_scan: Bx {tuple(Bx.shape)} / C "
                         f"{tuple(C.shape)} do not fit Abar {tuple(Abar.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, D, N):
        raise ValueError(f"mamba_scan: h0 {tuple(h0.shape)} is not "
                         f"{(B, D, N)}")
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    h_out = (torch.empty((B, D, N), dtype=torch.float32, device=dev)
             if return_state else None)
    if B * D == 0:
        return y, h_out
    rc = _build.load_library(SOURCE, _bind).ckio_mamba_scan(
        Abar.data_ptr(), Bx.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_out is None else h_out.data_ptr(), B, S, D, N,
        _build.stream_of(y))
    _build.check_rc(rc, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    return y, h_out
