"""Mamba-1 selective scan for Hopper, literal and fused: bind and launch.

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
``ssm_scan_ref``.

``mamba_scan_fused_cuda`` launches the fused kernel: the discretization,
the scan and the skip-and-gate epilogue of a Mamba layer in one launch,
from the conv output ``xin``, the ``dt_proj`` product ``dt_pre``, the
``x_proj`` output ``proj`` and the gate half ``z``, all in the compute
dtype (bf16 or fp32) and read through their strides, plus the fp32
parameters. It counts under ``LAUNCHES["mamba_scan_fused"]``; its plain
version is ``ref.mamba_scan_fused_ref``. Both kernels are forward-only.
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
    "comes with the training through the Hopper kernels slice (ROADMAP.md, "
    "Queue A)")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"mamba_scan": 0, "mamba_scan_fused": 0}
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ckio_mamba_scan.argtypes = [P, P, P, P, P, P, L, L, L, I, P]
    lib.ckio_mamba_scan.restype = ctypes.c_int
    lib.ckio_mamba_scan_fused.argtypes = [P] * 10 + [L, L, L, I, L, I, P, P]
    lib.ckio_mamba_scan_fused.restype = ctypes.c_int


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


def _fused_checks(xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0):
    """Dtypes, shapes and layouts, checked before the device and before
    any build; returns (B, S, D, N, r)."""
    if xin.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"mamba_scan_fused: xin must be bfloat16 or "
                         f"float32, got {xin.dtype}")
    if xin.dim() != 3:
        raise ValueError(f"mamba_scan_fused: xin must be (B, S, D), got "
                         f"shape {tuple(xin.shape)}")
    B, S, D = xin.shape
    if A_log.dim() != 2 or A_log.shape[0] != D:
        raise ValueError(f"mamba_scan_fused: A_log shape {tuple(A_log.shape)}"
                         f" is not (D={D}, N)")
    N = A_log.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_fused: state size {N} not in "
                         f"{STATE_SIZES}")
    acts = {"dt_pre": (dt_pre, (B, S, D)), "z": (z, (B, S, D)),
            "proj": (proj, (B, S, proj.shape[-1]))}
    for name, (t, shape) in acts.items():
        if t.dtype != xin.dtype:
            raise ValueError(f"mamba_scan_fused: {name} is {t.dtype}, xin "
                             f"{xin.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan_fused: {name} shape "
                             f"{tuple(t.shape)} is not {shape}")
    r = proj.shape[-1] - 2 * N
    if r < 0:
        raise ValueError(f"mamba_scan_fused: proj shape {tuple(proj.shape)} "
                         f"has fewer than 2N = {2 * N} columns")
    params = {"dt_bias": (dt_bias, (D,)), "A_log": (A_log, (D, N)),
              "Dskip": (Dskip, (D,))}
    if h0 is not None:
        params["h0"] = (h0, (B, D, N))
    for name, (t, shape) in params.items():
        if t.dtype != torch.float32:
            raise ValueError(f"mamba_scan_fused: {name} must be float32, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan_fused: {name} shape "
                             f"{tuple(t.shape)} is not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan_fused: {name} must be contiguous")
    return B, S, D, N, r


def mamba_scan_fused_cuda(
    xin: torch.Tensor,                  # (B, S, D) bf16 / fp32
    dt_pre: torch.Tensor,               # (B, S, D) as xin
    dt_bias: torch.Tensor,              # (D,) fp32
    A_log: torch.Tensor,                # (D, N) fp32
    proj: torch.Tensor,                 # (B, S, r+2N) as xin
    Dskip: torch.Tensor,                # (D,) fp32
    z: torch.Tensor,                    # (B, S, D) as xin
    *,
    h0: Optional[torch.Tensor] = None,  # (B, D, N) fp32
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``y`` (B, S, D) in the compute dtype and, with ``return_state``, the
    fp32 state after the last step (B, D, N); otherwise ``(y, None)``.
    ``xin``, ``dt_pre``, ``z`` and ``proj`` may be views with any strides
    (no copy is made); the parameters and ``h0`` must be contiguous."""
    B, S, D, N, r = _fused_checks(xin, dt_pre, dt_bias, A_log, proj, Dskip,
                                  z, h0)
    ins = [xin, dt_pre, z, proj, dt_bias, A_log, Dskip]
    if h0 is not None:
        ins.append(h0)
    dev = xin.device
    for t in ins:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"mamba_scan_fused: every input must be on one "
                             f"CUDA device ({t.device} and {dev})")
    y = torch.empty((B, S, D), dtype=xin.dtype, device=dev)
    h_out = (torch.empty((B, D, N), dtype=torch.float32, device=dev)
             if return_state else None)
    if B * D == 0:
        return y, h_out
    strides = (ctypes.c_longlong * 12)(
        *xin.stride(), *dt_pre.stride(), *z.stride(), *proj.stride())
    rc = _build.load_library(SOURCE, _bind).ckio_mamba_scan_fused(
        xin.data_ptr(), dt_pre.data_ptr(), z.data_ptr(), proj.data_ptr(),
        dt_bias.data_ptr(), A_log.data_ptr(), Dskip.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h_out is None else h_out.data_ptr(), B, S, D, N, r,
        int(xin.dtype == torch.bfloat16), strides, _build.stream_of(y))
    _build.check_rc(rc, "mamba_scan_fused")
    LAUNCHES["mamba_scan_fused"] += 1
    return y, h_out
