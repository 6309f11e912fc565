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
The kernel is forward-only: ``ops.flash_attention`` raises
:data:`FORWARD_ONLY` where autograd would need its gradient. A logit
softcap is computed by the decode path alone (``softcap``).

The kernel takes one of three paths, from the shapes and dtype alone
(:func:`path`): a split-key decode when the query rows of a kv head fit
one block, tensor-core tiles for other bf16 calls, CUDA-core tiles for
other fp32 calls. The decode path cuts the key axis by :func:`split_plan`,
which depends on (Sk, hd) only, so that a row gets the same bits at any
batch size; its fp32 partials go to a scratch tensor allocated here.
``kernels/ref.py``'s ``attention_split_ref`` is the plain version of the
split and of its fixed-order combine.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import reassemble as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 16       # query rows of a decode block (kMaxRows)
SPLIT_TILE = 32        # keys a tile of the decode kernel
MAX_SPLITS = 64        # kMaxSplits
FORWARD_ONLY = (
    "flash_attention: the CUDA attention kernel is forward-only: no path "
    "differentiates it (a loss differentiates the plain attention, as the "
    "reference's loss differentiates its plain _sdpa and never its Pallas "
    "kernel), and a decode or an encoder pass runs under torch.no_grad()")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def split_plan(sk: int, hd: int) -> Tuple[int, int]:
    """``(span, splits)``: the decode path cuts keys ``0..sk`` into
    ``splits`` spans of ``span`` keys. A span is whole 32-key tiles, at
    least 4,096 elements of k (one tile at hd >= 128), and there are at
    most 64 spans (a full 2,048-slot ring at hd 256 gets 64). A function of
    ``sk`` and ``hd`` only: never of the batch, the heads or the card."""
    tile_span = SPLIT_TILE * max(1, 128 // hd)
    tiles = -(-max(sk, 1) // tile_span)
    span = tile_span * -(-tiles // MAX_SPLITS)
    return span, -(-max(sk, 1) // span)


def split_range(sq: int, sk: int, span: int, *, window: int = 0
                ) -> Tuple[int, int]:
    """First and one-past-last split that the decode path launches: those
    that meet the keys some row keeps. Rows are end-aligned, so the last
    sits at ``sk - 1`` and a causal mask cuts no split; a window drops the
    splits wholly before ``sk - sq - window + 1``. An empty band launches
    split 0 alone, which writes zeros."""
    k_begin = max(0, sk - sq - window + 1) if window > 0 else 0
    if sk <= k_begin:
        return 0, 1
    return k_begin // span, (sk - 1) // span + 1


def path(sq: int, g: int, dtype: torch.dtype) -> str:
    """The launcher's choice: ``"decode"`` when the ``sq`` positions of a
    kv head's ``g`` query heads fit one 16-row block (every ``sq = 1``
    call), else ``"tensor_core"`` in bf16 and ``"cuda_core"`` in fp32."""
    if sq <= DECODE_ROWS // min(g, DECODE_ROWS):
        return "decode"
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def launch_plan(q_shape, k_shape, dtype: torch.dtype, *, window: int = 0
                ) -> dict:
    """What the wrapper launches for q ``(B, H, Sq, hd)`` and k ``(B, K,
    Sk, hd)``: the path, the split plan, the splits launched
    (``first..last``) and the fp32 scratch their partials need (0 with one
    split or off the decode path)."""
    B, H, Sq, hd = q_shape
    K, Sk = k_shape[1], k_shape[2]
    span, splits = split_plan(Sk, hd)
    kind = path(Sq, H // K, dtype)
    first, last = split_range(Sq, Sk, span, window=window)
    n = last - first if kind == "decode" else 0
    return {"path": kind, "span": span, "splits": splits, "first": first,
            "last": last,
            "scratch_floats": B * H * Sq * n * (hd + 2) if n > 1 else 0}


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ckio_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I,
                                         ctypes.c_double, ctypes.c_double,
                                         I, I, P, P]
    lib.ckio_flash_attention.restype = ctypes.c_int


def flash_attention_cuda(
    q: torch.Tensor,               # (B, H, Sq, hd), any strides
    k: torch.Tensor,               # (B, K, Sk, hd)
    v: torch.Tensor,               # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Online-softmax attention on the card; returns a ``(B, H, Sq, hd)``
    view of a ``(B, Sq, H, hd)`` contiguous tensor in q's dtype.
    ``softcap > 0`` caps the scaled scores on the decode path; the two
    prefill paths do not compute it, and a capped call that the plan puts
    there raises ``ValueError`` before any launch."""
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
    if softcap < 0:
        raise ValueError(f"flash_attention: softcap {softcap} < 0")
    plan = launch_plan(tuple(q.shape), tuple(k.shape), q.dtype, window=window)
    if softcap > 0 and plan["path"] != "decode":
        raise ValueError(f"flash_attention: softcap on the {plan['path']} "
                         f"path: only the decode kernel computes it (no "
                         f"capped caller reaches a prefill path)")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    scratch = None
    if plan["scratch_floats"]:
        scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                              device=dev)
    dims = (ctypes.c_longlong * 21)(
        B, H, K, Sq, Sk, *q.stride(), *k.stride(), *v.stride(), *out.stride())
    rc = _build.load_library(SOURCE, _bind).ckio_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims,
        _DTYPE_CODES[q.dtype], hd, int(bool(causal)), int(window),
        hd ** -0.5, float(softcap), plan["span"], plan["splits"],
        None if scratch is None else scratch.data_ptr(),
        _build.stream_of(out))
    _build.check_rc(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
