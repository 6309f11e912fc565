"""RG-LRU linear recurrence for Hopper, literal and gated: bind and launch.

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
``kernels/ref.py``'s ``lru_scan_ref``.

``rglru_scan_gated_cuda`` launches the gated instance: an RG-LRU layer's
gates, recurrence and output product ``y = h.to(dtype) * gate`` in one
launch, from the fp32 gate products, the fp32 gate parameters, and the
conv output ``xr`` and GeLU ``gate`` in the compute dtype (bf16 or fp32,
read through their strides). It counts under
``LAUNCHES["rglru_scan_gated"]``; its plain version is
``ref.rglru_scan_gated_ref``. Both instances are forward-only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import reassemble as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
FORWARD_ONLY = (
    "rglru_scan: the CUDA RG-LRU kernel is forward-only (the reference has "
    "no backward kernel either); training a recurrent model on the card "
    "comes with its own slice (ROADMAP.md, Queue A item 9)")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_gated": 0}
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ckio_rglru_scan.argtypes = [P, P, P, P, L, L, L, P]
    lib.ckio_rglru_scan.restype = ctypes.c_int
    lib.ckio_rglru_scan_gated.argtypes = [P] * 10 + [L, L, L, I, P, P]
    lib.ckio_rglru_scan_gated.restype = ctypes.c_int


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


def _gated_checks(r_pre, i_pre, b_r, b_i, lam, xr, gate, h0):
    """Dtypes, shapes and layouts, checked before the device and before
    any build; returns (B, S, W)."""
    if xr.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"rglru_scan_gated: xr must be bfloat16 or "
                         f"float32, got {xr.dtype}")
    if xr.dim() != 3:
        raise ValueError(f"rglru_scan_gated: xr must be (B, S, W), got "
                         f"shape {tuple(xr.shape)}")
    B, S, W = xr.shape
    if gate.dtype != xr.dtype or tuple(gate.shape) != (B, S, W):
        raise ValueError(f"rglru_scan_gated: gate {tuple(gate.shape)}/"
                         f"{gate.dtype} does not fit xr {(B, S, W)}/"
                         f"{xr.dtype}")
    fp32 = {"r_pre": (r_pre, (B, S, W)), "i_pre": (i_pre, (B, S, W)),
            "b_r": (b_r, (W,)), "b_i": (b_i, (W,)), "lam": (lam, (W,))}
    if h0 is not None:
        fp32["h0"] = (h0, (B, W))
    for name, (t, shape) in fp32.items():
        if t.dtype != torch.float32:
            raise ValueError(f"rglru_scan_gated: {name} must be float32, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"rglru_scan_gated: {name} shape "
                             f"{tuple(t.shape)} is not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan_gated: {name} must be contiguous")
    return B, S, W


def rglru_scan_gated_cuda(
    r_pre: torch.Tensor,                # (B, S, W) fp32
    i_pre: torch.Tensor,                # (B, S, W) fp32
    b_r: torch.Tensor,                  # (W,) fp32
    b_i: torch.Tensor,                  # (W,) fp32
    lam: torch.Tensor,                  # (W,) fp32
    xr: torch.Tensor,                   # (B, S, W) bf16 / fp32
    gate: torch.Tensor,                 # (B, S, W) as xr
    *,
    h0: Optional[torch.Tensor] = None,  # (B, W) fp32
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``y`` (B, S, W) in the compute dtype and, with ``return_state``, the
    fp32 state after the last step (B, W); otherwise ``(y, None)``."""
    B, S, W = _gated_checks(r_pre, i_pre, b_r, b_i, lam, xr, gate, h0)
    ins = [r_pre, i_pre, b_r, b_i, lam, xr, gate]
    if h0 is not None:
        ins.append(h0)
    dev = xr.device
    for t in ins:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"rglru_scan_gated: every input must be on one "
                             f"CUDA device ({t.device} and {dev})")
    y = torch.empty((B, S, W), dtype=xr.dtype, device=dev)
    h_out = (torch.empty((B, W), dtype=torch.float32, device=dev)
             if return_state else None)
    if B * W == 0:
        return y, h_out
    strides = (ctypes.c_longlong * 6)(*xr.stride(), *gate.stride())
    rc = _build.load_library(SOURCE, _bind).ckio_rglru_scan_gated(
        r_pre.data_ptr(), i_pre.data_ptr(), xr.data_ptr(), gate.data_ptr(),
        b_r.data_ptr(), b_i.data_ptr(), lam.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_out is None else h_out.data_ptr(), B, S, W,
        int(xr.dtype == torch.bfloat16), strides, _build.stream_of(y))
    _build.check_rc(rc, "rglru_scan_gated")
    LAUNCHES["rglru_scan_gated"] += 1
    return y, h_out
