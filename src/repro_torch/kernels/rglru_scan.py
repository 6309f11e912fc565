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
``ref.rglru_scan_gated_ref``.

The gated entry has a gradient: :class:`RGLRUScanGatedFn`
(``torch.autograd.Function``) saves the inputs, not the states; its
backward launches ``lru_bwd_kernel`` on the card
(``rglru_scan_gated_backward_cuda``, counted under
``LAUNCHES["rglru_scan_gated_backward"]``), which recomputes the states in
the forward kernel's chunks (:data:`BWD_CHUNKS` of :data:`BWD_STEPS`
steps a segment), and runs ``ref.rglru_scan_gated_bwd_ref`` on the CPU. A
gradient through the returned state raises :data:`STATE_GRAD`. The literal
instance stays forward-only (:data:`FORWARD_ONLY`).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import reassemble as _build
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
FORWARD_ONLY = (
    "rglru_scan: the literal CUDA RG-LRU kernel is forward-only: no path "
    "differentiates it (every RG-LRU layer runs the gated entry, whose "
    "backward is a kernel; the reference never differentiates its Pallas "
    "kernel either)")
STATE_GRAD = ("rglru_scan_gated: a gradient through the returned state h_S "
              "(no loss reads it; the backward kernel takes dL/dy alone)")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_gated": 0,
                            "rglru_scan_gated_backward": 0}
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
# lru_kernel's and lru_bwd_kernel's chunking (csrc/rglru_scan.cu): a block
# walks segments of BWD_CHUNKS chunks of BWD_STEPS steps.
BWD_CHUNKS, BWD_STEPS = 16, 8
BWD_SEGMENT = BWD_CHUNKS * BWD_STEPS


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ckio_rglru_scan.argtypes = [P, P, P, P, L, L, L, P]
    lib.ckio_rglru_scan.restype = ctypes.c_int
    lib.ckio_rglru_scan_gated.argtypes = [P] * 10 + [L, L, L, I, P, P]
    lib.ckio_rglru_scan_gated.restype = ctypes.c_int
    lib.ckio_rglru_scan_gated_backward.argtypes = [P] * 17 + [L, L, L, I, P,
                                                              P]
    lib.ckio_rglru_scan_gated_backward.restype = ctypes.c_int


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


def backward_scratch(B: int, S: int, W: int) -> Dict[str, int]:
    """Floats of each scratch buffer of ``lru_bwd_kernel``: the state at
    each segment's start (B, ceil(S / BWD_SEGMENT), W), and the per-row
    sums of dc, db_r and db_i (3, B, W)."""
    return {"hseg": B * -(-S // BWD_SEGMENT) * W, "part": 3 * B * W}


def rglru_scan_gated_backward_cuda(
    gy: torch.Tensor,                   # (B, S, W) compute dtype
    r_pre: torch.Tensor,
    i_pre: torch.Tensor,
    b_r: torch.Tensor,
    b_i: torch.Tensor,
    lam: torch.Tensor,
    xr: torch.Tensor,
    gate: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """The gated entry's gradient from ``dL/dy``: ``(dr_pre, di_pre, db_r,
    db_i, dlam, dxr, dgate, dh0)``, each in its input's dtype and shape
    (``dxr``, ``dgate`` contiguous), ``dh0`` None without ``h0``; ``gy``,
    ``xr`` and ``gate`` are read through their strides. One call of
    ``ckio_rglru_scan_gated_backward`` (the kernel and the ordered sum over
    B of its per-row sums), then ``dlam`` from the summed ``dL/dc``, ``c =
    -8 softplus(lam)``, by torch's softplus derivative on a (W,) tensor.
    Counts under ``LAUNCHES["rglru_scan_gated_backward"]``."""
    B, S, W = _gated_checks(r_pre, i_pre, b_r, b_i, lam, xr, gate, h0)
    ins = [gy, r_pre, i_pre, b_r, b_i, lam, xr, gate]
    if h0 is not None:
        ins.append(h0)
    dev = xr.device
    for t in ins:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"rglru_scan_gated_backward: every input must "
                             f"be on one CUDA device ({t.device} and {dev})")
    if gy.dtype != xr.dtype or tuple(gy.shape) != (B, S, W):
        raise ValueError(f"rglru_scan_gated_backward: gy is {gy.dtype} "
                         f"{tuple(gy.shape)}, expected {xr.dtype} "
                         f"{(B, S, W)}")
    dr = torch.empty_like(r_pre)
    di = torch.empty_like(i_pre)
    dxr = torch.empty((B, S, W), dtype=xr.dtype, device=dev)
    dgate = torch.empty_like(dxr)
    dh0 = None if h0 is None else torch.empty_like(h0)
    dsum = torch.zeros((3, W), dtype=torch.float32, device=dev)
    if B * S * W == 0:
        for t in (dr, di, dxr, dgate) + (() if dh0 is None else (dh0,)):
            t.zero_()
    else:
        sizes = backward_scratch(B, S, W)
        hseg = torch.empty(sizes["hseg"], dtype=torch.float32, device=dev)
        part = torch.empty(sizes["part"], dtype=torch.float32, device=dev)
        strides = (ctypes.c_longlong * 9)(*xr.stride(), *gate.stride(),
                                          *gy.stride())
        rc = _build.load_library(SOURCE, _bind).ckio_rglru_scan_gated_backward(
            r_pre.data_ptr(), i_pre.data_ptr(), xr.data_ptr(),
            gate.data_ptr(), gy.data_ptr(), b_r.data_ptr(), b_i.data_ptr(),
            lam.data_ptr(), None if h0 is None else h0.data_ptr(),
            dr.data_ptr(), di.data_ptr(), dxr.data_ptr(), dgate.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), hseg.data_ptr(),
            part.data_ptr(), dsum.data_ptr(), B, S, W,
            int(xr.dtype == torch.bfloat16), strides, _build.stream_of(dr))
        _build.check_rc(rc, "rglru_scan_gated_backward")
        LAUNCHES["rglru_scan_gated_backward"] += 1
        del hseg, part
    dc, dbr, dbi = dsum
    dlam = torch.ops.aten.softplus_backward(dc * -ref.RGLRU_C, lam, 1.0, 20.0)
    return dr, di, dbr, dbi, dlam, dxr, dgate, dh0


class RGLRUScanGatedFn(torch.autograd.Function):
    """``ops.rglru_scan_gated`` with its gradient: the kernels on the card,
    the plain versions on the CPU. Saves the inputs, not the states."""

    @staticmethod
    def forward(ctx, cuda: bool, r_pre, i_pre, b_r, b_i, lam, xr, gate, h0,
                return_state: bool):
        args = (r_pre, i_pre, b_r, b_i, lam, xr, gate)
        if cuda:
            y, h = rglru_scan_gated_cuda(*args, h0=h0,
                                         return_state=return_state)
        else:
            y, h = ref.rglru_scan_gated_ref(*args, h0, return_state=True)
            h = h if return_state else None
        ctx.cuda, ctx.has_h0 = cuda, h0 is not None
        ctx.save_for_backward(*args, *(() if h0 is None else (h0,)))
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        if gh is not None:
            raise NotImplementedError(STATE_GRAD)
        saved = ctx.saved_tensors
        h0 = saved[7] if ctx.has_h0 else None
        if gy is None:
            return (None,) * 10
        bwd = (rglru_scan_gated_backward_cuda if ctx.cuda
               else ref.rglru_scan_gated_bwd_ref)
        grads = bwd(gy, *saved[:7], h0)
        return (None, *grads, None)

