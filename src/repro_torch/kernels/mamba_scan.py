"""Mamba-1 selective scan for Hopper, literal and fused: bind and launch.

``csrc/mamba_scan.cu`` holds the kernels, but the literal backward's,
which is in ``csrc/mamba_scan_bwd.cu`` (what each replaces, what bounds it
and its design are noted there). Each is built at first launch by the
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
version is ``ref.mamba_scan_fused_ref``.

Each entry has a gradient: :class:`MambaScanFn` and
:class:`MambaScanFusedFn` (``torch.autograd.Function``) save the inputs,
not the states, and their backward recomputes the states. On the card it
launches ``scan_bwd_cluster_kernel`` (``mamba_scan_backward_cuda``, from
``csrc/mamba_scan_bwd.cu``: a thread-block cluster a batch row and group
of states, the chunks' carries traded through distributed shared memory;
counted under
``LAUNCHES["mamba_scan_backward"]``) or the chunked fused backward
(``mamba_scan_fused_backward_cuda``, ``LAUNCHES["mamba_scan_fused_backward"]``:
the softplus, skip and gate derivatives are folded into its loads and
stores); on the CPU the plain backward of ``kernels/ref.py``. A gradient
through a returned state raises :data:`STATE_GRAD`: no loss reads it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import reassemble as _build
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")   # the literal backward
STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N: a power of two, one warp at most
# The literal backward's plan (csrc/mamba_scan_bwd.cu scan_bwd_cluster_kernel,
# scan_bwd_plan): clusters of SCAN_BWD_CLUSTER blocks; at most
# SCAN_BWD_MAX_STATES states a block, SCAN_BWD_SPLIT threads a state; chunks
# of at most SCAN_BWD_MAX_CHUNK steps (one TMA box of rows); SCAN_BWD_SMEM
# bytes of shared memory a block, the most an H100 block may have.
SCAN_BWD_CLUSTER = 16
SCAN_BWD_MAX_STATES = 128
SCAN_BWD_SPLIT = 4
SCAN_BWD_MAX_CHUNK = 256
SCAN_BWD_SMEM = 227 * 1024
# The fused backward's chunking (csrc/mamba_scan.cu FusedBwdShape): a block
# owns FUSED_BWD_CHUNK steps of fused_bwd_channels(N) channels and
# recomputes FUSED_BWD_SUBSEG steps at a time.
FUSED_BWD_CHUNK = 64
FUSED_BWD_SUBSEG = 8
STATE_GRAD = ("mamba_scan: a gradient through the returned state h_S (no "
              "loss reads it; the backward kernels take dL/dy alone)")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"mamba_scan": 0, "mamba_scan_fused": 0,
                            "mamba_scan_backward": 0,
                            "mamba_scan_fused_backward": 0}
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
    lib.ckio_mamba_scan_fused_backward.argtypes = [P] * 21 + [L, L, L, I, L, I,
                                                               P, P]
    lib.ckio_mamba_scan_fused_backward.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ckio_mamba_scan_backward.argtypes = [P] * 11 + [L] * 3 + [I] * 7 + [P]
    lib.ckio_mamba_scan_backward.restype = ctypes.c_int
    lib.ckio_mamba_scan_backward_clusters.argtypes = [I, I, I, I, P]
    lib.ckio_mamba_scan_backward_clusters.restype = ctypes.c_int


def _scan_bwd_smem(G: int, L: int, N: int) -> int:
    """Shared-memory bytes of a backward block (``bwd_smem_floats``): two
    buffers, each of Abar and Bx (L x G each), gy (L rows of ``cols``: the
    G/N channels from an offset below 4, so that a row's TMA box starts
    16-byte aligned; rounded up to 128 bytes) and C (L x N), rounded up to
    128 bytes; the sub-chunks' (P, e, r) (SCAN_BWD_SPLIT x 3 x G), two of
    the chunk's (3 x G) and its carries (2 x G); two 8-byte mbarriers."""
    up = lambda v, q: -(-v // q) * q  # noqa: E731
    gc = G // N
    cols = up(gc + 4 - min(gc & -gc, 4), 4)
    gy = up(L * cols, 32)
    buf = up(2 * L * G + gy + L * N, 32)
    return 4 * (2 * buf + (3 * SCAN_BWD_SPLIT + 8) * G + 4)


def scan_bwd_plan(B: int, S: int, D: int, N: int,
                  smem: Optional[int] = None) -> Dict[str, object]:
    """The launch of ``scan_bwd_cluster_kernel`` for (B, S, D, N): clusters
    of ``cluster`` blocks take items (b, group of ``states`` states, a
    multiple of 32: ``states`` // N channels) in turn; block k walks chunk
    k of ``chunk`` steps of each with ``threads`` threads (SCAN_BWD_SPLIT a
    state), the chunk's inputs held in shared memory, two items' worth in
    ``smem`` bytes (the next item's copies land while this one is walked).
    The most states that fit at ``chunk`` = ceil(S / cluster) are taken;
    where ``chunk`` would pass SCAN_BWD_MAX_CHUNK or not even 32 states
    fit, the sequence is walked in ``windows`` windows of ``cluster``
    chunks (24 bytes a state element instead of 16, ``elem_bytes``).
    ``scratch`` gives the floats of ``part`` (the groups' dC partials, (B,
    groups, S, N)) and ``carry`` (the windows' carry-in states, (B,
    windows, D, N), 0 with one window); ``side_bytes`` the bytes of gy, C
    (read by each group), part (written and read), dC, h0 and dh0, and
    carry. ``smem`` is a block's budget, SCAN_BWD_SMEM by default (a
    smaller one makes windows at small shapes)."""
    smem = SCAN_BWD_SMEM if smem is None else smem
    K = SCAN_BWD_CLUSTER
    L = max(1, -(-S // K))
    top = min(SCAN_BWD_MAX_STATES, 32 * -(-(D * N) // 32))
    fits = [G for G in range(top, 0, -32) if _scan_bwd_smem(G, L, N) <= smem]
    windows = 1
    if fits and L <= SCAN_BWD_MAX_CHUNK:
        G = fits[0]
    else:
        G = 32
        L = max([n for n in range(1, SCAN_BWD_MAX_CHUNK + 1)
                 if _scan_bwd_smem(G, n, N) <= smem], default=0)
        if L < 1:
            raise ValueError(f"mamba_scan_backward: {smem} bytes of shared "
                             f"memory hold no step of {G} states")
        windows = -(-S // (K * L))
        L = -(-S // (K * windows))
    groups = -(-(D * N) // G)
    scratch = {"part": B * groups * S * N,
               "carry": B * windows * D * N if windows > 1 else 0}
    side = 4 * (B * S * D + B * S * N * groups + 2 * scratch["part"]
                + B * S * N + 2 * B * D * N + 2 * scratch["carry"])
    return {"cluster": K, "chunk": L, "states": G,
            "threads": SCAN_BWD_SPLIT * G, "windows": windows,
            "groups": groups, "smem": _scan_bwd_smem(G, L, N),
            "scratch": scratch, "elem_bytes": 16 if windows == 1 else 24,
            "side_bytes": side}


def scan_bwd_clusters(plan: Dict[str, object], N: int) -> int:
    """How many clusters of ``plan``'s shape the card runs at once (the
    occupancy query the launch makes; 0 where it refuses the shape)."""
    out = ctypes.c_int(0)
    lib = _build.load_library(BWD_SOURCE, _bind_bwd)
    rc = lib.ckio_mamba_scan_backward_clusters(
        N, plan["cluster"], plan["states"], plan["smem"], ctypes.byref(out))
    _build.check_rc(rc, "mamba_scan_backward")
    return out.value


def fused_bwd_channels(N: int) -> int:
    """Channels a block of the fused backward (``FusedBwdShape::kG``):
    their sums over d of dBc and dCc are taken before they leave it."""
    return 64 if N == 32 else 128


def fused_bwd_scratch(B: int, S: int, D: int, N: int,
                      itemsize: int = 2) -> Dict[str, int]:
    """Floats of each scratch buffer of the fused backward: the chunks'
    summaries, then their carries (two (B, C, D, N) and a (B, C, D), C =
    ceil(S / FUSED_BWD_CHUNK)), the blocks' partial sums of dBc | dCc (B,
    S, ceil(D / fused_bwd_channels(N)), 2N), the (b, chunk) partials of dA
    (B*C, D, N) and of dDskip and ddt_bias (2, B*C, D), and two (B, S, D)
    planes of value pairs in the compute dtype (``itemsize`` bytes a
    value): (dt, dy) and the epilogue's two factors, which the summary
    kernel computes once for the emitting kernel."""
    C = -(-S // FUSED_BWD_CHUNK)
    nblk = -(-D // fused_bwd_channels(N))
    # The planes first: their 8-byte pairs (fp32) need an aligned start.
    return {"planes": B * S * D * itemsize,
            "sums": B * C * D * (2 * N + 1), "part": B * S * nblk * 2 * N,
            "dApart": B * C * D * N, "chan": 2 * B * C * D}


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


def _on_one_device(name: str, tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device ({t.device} and {dev})")
    return dev


def mamba_scan_backward_cuda(
    gy: torch.Tensor,                   # (B, S, D) fp32
    Abar: torch.Tensor,                 # (B, S, D, N) fp32
    Bx: torch.Tensor,                   # (B, S, D, N) fp32
    C: torch.Tensor,                    # (B, S, N) fp32
    h0: Optional[torch.Tensor] = None,  # (B, D, N) fp32
):
    """The literal scan's gradient from ``dL/dy``: ``(dAbar, dBx, dC,
    dh0)``, ``dh0`` None without ``h0``. One launch of
    ``scan_bwd_cluster_kernel`` on :func:`scan_bwd_plan`'s plan: each
    cluster's blocks hold their chunks of Abar and Bx in shared memory,
    trade the chunks' products, local end states and local adjoints through
    distributed shared memory, fold them in rank order into each chunk's
    state and adjoint carries, and write dAbar and dBx once; the states are
    recomputed, never stored. ``dC``'s sum over D is the groups' partials,
    then an ordered sum. Raises before any launch on a plan the card
    refuses. Counts under ``LAUNCHES["mamba_scan_backward"]``."""
    ins = [gy, Abar, Bx, C] + ([] if h0 is None else [h0])
    dev = _on_one_device("mamba_scan_backward", ins)
    if Abar.dim() != 4:
        raise ValueError(f"mamba_scan_backward: Abar must be (B, S, D, N), "
                         f"got {tuple(Abar.shape)}")
    B, S, D, N = Abar.shape
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan_backward: state size {N} not in "
                         f"{STATE_SIZES}")
    want = {"gy": (gy, (B, S, D)), "Abar": (Abar, (B, S, D, N)),
            "Bx": (Bx, (B, S, D, N)), "C": (C, (B, S, N))}
    if h0 is not None:
        want["h0"] = (h0, (B, D, N))
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan_backward: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 {shape}")
    gy = gy.contiguous()
    for name, (t, _) in want.items():
        if name != "gy" and not t.is_contiguous():
            raise ValueError(f"mamba_scan_backward: {name} must be contiguous")
    dA = torch.empty_like(Abar)
    dBx = torch.empty_like(Bx)
    dC = torch.empty_like(C)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if B * S * D == 0:
        for t in (dA, dBx, dC) + (() if dh0 is None else (dh0,)):
            t.zero_()
        return dA, dBx, dC, dh0
    plan = scan_bwd_plan(B, S, D, N)
    sizes = plan["scratch"]
    scratch = torch.empty(sizes["part"] + sizes["carry"], dtype=torch.float32,
                          device=dev)
    carry = scratch.data_ptr() + 4 * sizes["part"] if sizes["carry"] else None
    rc = _build.load_library(BWD_SOURCE, _bind_bwd).ckio_mamba_scan_backward(
        Abar.data_ptr(), Bx.data_ptr(), C.data_ptr(),
        None if h0 is None else h0.data_ptr(), gy.data_ptr(), dA.data_ptr(),
        dBx.data_ptr(), dC.data_ptr(), None if dh0 is None else dh0.data_ptr(),
        scratch.data_ptr(), carry, B, S, D, N, plan["cluster"], plan["chunk"],
        plan["states"], plan["windows"], plan["groups"], plan["smem"],
        _build.stream_of(dA))
    _build.check_rc(rc, "mamba_scan_backward")
    LAUNCHES["mamba_scan_backward"] += 1
    return dA, dBx, dC, dh0


def mamba_scan_fused_backward_cuda(
    gy: torch.Tensor,                   # (B, S, D) compute dtype
    xin: torch.Tensor,
    dt_pre: torch.Tensor,
    dt_bias: torch.Tensor,
    A_log: torch.Tensor,
    proj: torch.Tensor,
    Dskip: torch.Tensor,
    z: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """The fused entry's gradient from ``dL/dy``: ``(dxin, ddt_pre,
    ddt_bias, dA_log, dproj, dDskip, dz, dh0)``, each in its input's dtype
    and shape (the (B, S, ...) ones contiguous), ``dh0`` None without
    ``h0``. One call of ``ckio_mamba_scan_fused_backward``: the chunked
    kernels read ``gy``, ``xin``, ``dt_pre``, ``z`` and ``proj`` through
    their strides in the compute dtype, recompute ``dt``, ``Abar``, ``Bx``
    and the states, differentiate the discretization, the scan, the skip,
    the gate and the softplus with the plain backward's rounding, and write
    ``dxin``, ``ddt_pre``, ``dz`` and ``dproj`` (its first r columns 0)
    once. What stays in torch: ``A = -exp(A_log)``, ``dA_log = dA * A``
    and the rounding of the fp32 sums of ``dDskip`` and ``ddt_bias`` to the
    compute dtype, on (D, N) and (D,) tensors. No (B, S, D, N) tensor is
    allocated (:func:`fused_bwd_scratch`). Counts under
    ``LAUNCHES["mamba_scan_fused_backward"]``."""
    B, S, D, N, r = _fused_checks(xin, dt_pre, dt_bias, A_log, proj, Dskip,
                                  z, h0)
    ins = [gy, xin, dt_pre, dt_bias, A_log, proj, Dskip, z]
    dev = _on_one_device("mamba_scan_fused_backward",
                         ins + ([] if h0 is None else [h0]))
    dtype = xin.dtype
    if gy.dtype != dtype or tuple(gy.shape) != (B, S, D):
        raise ValueError(f"mamba_scan_fused_backward: gy is {gy.dtype} "
                         f"{tuple(gy.shape)}, expected {dtype} {(B, S, D)}")
    f32 = torch.float32
    dxin = torch.empty((B, S, D), dtype=dtype, device=dev)
    ddt = torch.empty_like(dxin)
    dz = torch.empty_like(dxin)
    dproj = torch.empty((B, S, r + 2 * N), dtype=dtype, device=dev)
    dA = torch.empty((D, N), dtype=f32, device=dev)
    dchan = torch.empty((2, D), dtype=f32, device=dev)   # dDskip, ddt_bias
    dh0 = None if h0 is None else torch.empty_like(h0)
    if B * S * D == 0:
        for t in (dxin, ddt, dz, dproj, dA, dchan) + (
                () if dh0 is None else (dh0,)):
            t.zero_()
    else:
        sizes = fused_bwd_scratch(B, S, D, N, xin.element_size())
        scratch = torch.empty(sum(sizes.values()), dtype=f32, device=dev)
        ptrs, at = {}, scratch.data_ptr()
        for name, n in sizes.items():
            ptrs[name] = at
            at += 4 * n
        strides = (ctypes.c_longlong * 15)(
            *gy.stride(), *xin.stride(), *dt_pre.stride(), *z.stride(),
            *proj.stride())
        rc = _build.load_library(SOURCE, _bind).ckio_mamba_scan_fused_backward(
            gy.data_ptr(), xin.data_ptr(), dt_pre.data_ptr(), z.data_ptr(),
            proj.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
            Dskip.data_ptr(), None if h0 is None else h0.data_ptr(),
            dxin.data_ptr(), ddt.data_ptr(), dz.data_ptr(), dproj.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), ptrs["sums"],
            ptrs["part"], ptrs["dApart"], ptrs["chan"], ptrs["planes"],
            dA.data_ptr(), dchan.data_ptr(), B, S, D, N, r,
            int(dtype == torch.bfloat16), strides, _build.stream_of(dxin))
        _build.check_rc(rc, "mamba_scan_fused_backward")
        LAUNCHES["mamba_scan_fused_backward"] += 1
        del scratch
    dDskip, dbias = dchan.to(dtype).to(f32)
    return (dxin, ddt, dbias, dA * -torch.exp(A_log), dproj, dDskip, dz, dh0)


class MambaScanFn(torch.autograd.Function):
    """``ops.mamba_scan`` with its gradient: the kernels on the card, the
    plain versions on the CPU. Saves the inputs, not the states."""

    @staticmethod
    def forward(ctx, cuda: bool, Abar, Bx, C, h0, return_state: bool):
        if cuda:
            y, h = mamba_scan_cuda(Abar, Bx, C, h0=h0,
                                   return_state=return_state)
        else:
            y, h = ref.ssm_scan_ref(Abar, Bx, C, h0, return_state=True)
            h = h if return_state else None
        ctx.cuda, ctx.has_h0 = cuda, h0 is not None
        ctx.save_for_backward(Abar, Bx, C, *(() if h0 is None else (h0,)))
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        if gh is not None:
            raise NotImplementedError(STATE_GRAD)
        Abar, Bx, C, *h0 = ctx.saved_tensors
        h0 = h0[0] if h0 else None
        if gy is None:
            return (None,) * 6
        bwd = mamba_scan_backward_cuda if ctx.cuda else ref.ssm_scan_bwd_ref
        dA, dB, dC, dh0 = bwd(gy, Abar, Bx, C, h0)
        return None, dA, dB, dC, dh0, None


class MambaScanFusedFn(torch.autograd.Function):
    """``ops.mamba_scan_fused`` with its gradient: the kernels on the card,
    the plain versions on the CPU. Saves the inputs, not the states."""

    @staticmethod
    def forward(ctx, cuda: bool, xin, dt_pre, dt_bias, A_log, proj, Dskip, z,
                h0, return_state: bool):
        args = (xin, dt_pre, dt_bias, A_log, proj, Dskip, z)
        if cuda:
            y, h = mamba_scan_fused_cuda(*args, h0=h0,
                                         return_state=return_state)
        else:
            y, h = ref.mamba_scan_fused_ref(*args, h0, return_state=True)
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
        bwd = (mamba_scan_fused_backward_cuda if ctx.cuda
               else ref.mamba_scan_fused_bwd_ref)
        grads = bwd(gy, *saved[:7], h0)
        return (None, *grads, None)

