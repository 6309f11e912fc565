"""Flash attention for Hopper, forward and backward: bind and launch.

``csrc/flash_attention.cu`` holds the forward kernels and
``csrc/flash_attention_bwd.cu`` the backward ones (what each replaces, what
bounds it and its design are noted there). They are built at first launch
by the package's builder (``kernels/reassemble.py``: ``nvcc`` for
``sm_90a`` into the build directory, loaded with ``ctypes``), never at
import.

The wrapper takes q ``(B, H, Sq, hd)`` and k/v ``(B, K, Sk, hd)`` as views
with any strides, so ``ops.flash_attention`` passes the ``(B, S, H, hd)``
activations and a ``(B, C, K, hd)`` cache prefix in place (no transposed
copy). It checks device, dtype, rank and head size, allocates the output
with ``torch.empty``, launches on the current stream, raises if the
launcher reports a CUDA error and adds one to :data:`LAUNCHES`. The plain
version of the same function is ``kernels/ref.py``'s ``attention_ref``.
``ops.flash_attention`` is forward-only and raises :data:`FORWARD_ONLY`
where autograd would need its gradient. A logit softcap is computed by the
decode path alone (``softcap``).

Training differentiates attention through :class:`FlashAttentionTrainFn`
(``ops.flash_attention_train``): :func:`flash_attention_train_cuda`, the
tensor-core path writing each row's log-sum-exp beside the output, and
:func:`flash_attention_backward_cuda`, which recomputes the probabilities
from it (bf16, causal with an optional window, hd in
:data:`TRAIN_HEAD_DIMS`). Their plain versions are ``ref.py``'s
``attention_train_ref`` and ``attention_train_bwd_ref``.

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
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import reassemble as _build
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_BWD = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128, 256)
TRAIN_HEAD_DIMS = (64, 128, 256)   # the training forward's and the backward's
ROW_PAD = 64                       # the backward's row scratch (kRowPad)
MAX_DKV_SPLITS = 8                 # blocks sharing a key tile of dK/dV
DKV_PART_ROWS = 256                # the fewest query rows a part may walk
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_ROWS = 16       # query rows of a decode block (kMaxRows)
SPLIT_TILE = 32        # keys a tile of the decode kernel
MAX_SPLITS = 64        # kMaxSplits
FORWARD_ONLY = (
    "flash_attention: this entry is forward-only (a decode or an encoder "
    "pass runs under torch.no_grad()); training differentiates causal "
    "attention through ops.flash_attention_train, whose backward is the "
    "flash_attention_backward kernel")

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_train": 0,
                            "flash_attention_backward": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ckio_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I, D, D,
                                         I, I, P, P]
    lib.ckio_flash_attention.restype = ctypes.c_int
    lib.ckio_flash_attention_train.argtypes = [P, P, P, P, P, P, I, I, D, P]
    lib.ckio_flash_attention_train.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ckio_flash_attention_backward.argtypes = [P] * 11 + [I, I,
                                                             ctypes.c_double, P]
    lib.ckio_flash_attention_backward.restype = ctypes.c_int


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


def _check_train(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int) -> None:
    """q ``(B, H, S, hd)``, k and v ``(B, K, S, hd)`` views on one card in
    bf16, hd in :data:`TRAIN_HEAD_DIMS`, G = H/K whole."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: q, k, v must be on one CUDA device "
                             f"(got {q.device}, {k.device}, {v.device})")
        if t.dim() != 4 or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: 4-D bfloat16 inputs expected, got "
                             f"{tuple(t.shape)} {t.dtype}")
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if hd not in TRAIN_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {TRAIN_HEAD_DIMS}")
    if tuple(k.shape) != (B, K, Sk, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"{name}: {H} query heads over {K} kv heads")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")


def dkv_splits(B: int, K: int, Sq: int, Sk: int, H: int, hd: int,
               sms: int) -> int:
    """Blocks that share one key tile of the backward's dK/dV kernel: 1
    where its B * K * (key tiles) blocks fill the card's ``sms``
    multiprocessors, else enough for about two blocks an SM, at most
    :data:`MAX_DKV_SPLITS` and each walking at least :data:`DKV_PART_ROWS`
    of the Sq * H/K query rows of a kv head. A split key tile sums its
    parts in a fixed order, so a shape keeps its bits on one card."""
    blocks = B * K * -(-Sk // (32 if hd >= 256 else 64))
    if blocks >= sms or Sk < 1:
        return 1
    rows = Sq * (H // K)
    return max(1, min(MAX_DKV_SPLITS, -(-2 * sms // blocks),
                      -(-rows // DKV_PART_ROWS)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_train_cuda(
    q: torch.Tensor,               # (B, H, Sq, hd), any strides
    k: torch.Tensor,               # (B, K, Sk, hd)
    v: torch.Tensor,               # (B, K, Sk, hd)
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: causal attention (with ``window`` > 0, a
    sliding window too) on the tensor-core path at every shape, returning
    the output, a ``(B, H, Sq, hd)`` view of a ``(B, Sq, H, hd)`` bf16
    tensor, and each row's log-sum-exp of its kept scaled scores, ``(B, H,
    Sq)`` fp32 (+inf for a row that keeps no key, whose output is 0)."""
    _check_train("flash_attention_train", q, k, v, window)
    B, H, Sq, hd = q.shape
    dev = q.device
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dims = (ctypes.c_longlong * 21)(
        B, H, k.shape[1], Sq, k.shape[2], *q.stride(), *k.stride(),
        *v.stride(), *out.stride())
    rc = _build.load_library(SOURCE, _bind).ckio_flash_attention_train(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dims, hd, int(window), hd ** -0.5,
        _build.stream_of(out))
    _build.check_rc(rc, "flash_attention_train")
    LAUNCHES["flash_attention_train"] += 1
    return out, lse


def flash_attention_backward_cuda(
    dout: torch.Tensor,            # (B, H, Sq, hd), any strides
    q: torch.Tensor,               # (B, H, Sq, hd)
    k: torch.Tensor,               # (B, K, Sk, hd)
    v: torch.Tensor,               # (B, K, Sk, hd)
    out: torch.Tensor,             # (B, H, Sq, hd): the training forward's
    lse: torch.Tensor,             # (B, H, Sq) fp32: the training forward's
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`flash_attention_train_cuda` with respect to
    q, k and v: ``(B, H, Sq, hd)``, ``(B, K, Sk, hd)`` and ``(B, K, Sk,
    hd)`` views of ``(B, S, heads, hd)`` bf16 tensors. Three launches (the
    row dot products, dK/dV, dQ; four where :func:`dkv_splits` splits the
    key tiles) counted as one call; no atomics, so the same inputs give the
    same bits."""
    _check_train("flash_attention_backward", q, k, v, window)
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    for t in (dout, out):
        if (tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype
                or t.device != q.device):
            raise ValueError(f"flash_attention_backward: {tuple(t.shape)} "
                             f"{t.dtype} does not fit q {tuple(q.shape)}")
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: lse must be a contiguous "
                         f"(B, H, Sq) float32 tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dev = q.device
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((B, Sk, K, hd), dtype=q.dtype, device=dev).transpose(1, 2)
    fp = -(-Sq * (H // K) // ROW_PAD) * ROW_PAD
    splits = dkv_splits(B, K, Sq, Sk, H, hd, _sm_count(dev.index))
    parts = 2 * splits * B * K * Sk * hd if splits > 1 else 0
    scratch = torch.empty(2 * B * K * fp + parts, dtype=torch.float32,
                          device=dev)
    dims = (ctypes.c_longlong * 38)(
        B, H, K, Sq, Sk, *q.stride(), *k.stride(), *v.stride(),
        *out.stride(), *dout.stride(), *dq.stride(), *dk.stride(),
        *dv.stride(), splits)
    lib = _build.load_library(SOURCE_BWD, _bind_bwd)
    rc = lib.ckio_flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(), dims, hd, int(window), hd ** -0.5,
        _build.stream_of(dq))
    _build.check_rc(rc, "flash_attention_backward")
    LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dv


class FlashAttentionTrainFn(torch.autograd.Function):
    """Causal attention with its gradient, in the ``(B, S, heads, hd)``
    layout: the training forward and the backward kernels on the card, the
    plain versions (``ref.attention_train_ref`` / ``attention_train_bwd_ref``)
    on the CPU. Saves q, k, v, the output and the log-sum-exp. The CUDA
    entries are looked up in this module's globals at each call, so a
    wrapper put there (a profiler range) sees every call: the forward, an
    activation checkpoint's recompute and the backward."""

    @staticmethod
    def forward(ctx, cuda: bool, q, k, v, window: int):
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if cuda:
            out, lse = flash_attention_train_cuda(qt, kt, vt, window=window)
        else:
            out, lse = ref.attention_train_ref(qt, kt, vt, window=window)
        ctx.cuda, ctx.window = cuda, window
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, gout):
        if gout is None:
            return None, None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_backward_cuda if ctx.cuda
               else ref.attention_train_bwd_ref)
        dq, dk, dv = bwd(gout.transpose(1, 2), q.transpose(1, 2),
                         k.transpose(1, 2), v.transpose(1, 2), out, lse,
                         window=ctx.window)
        return (None, dq.transpose(1, 2), dk.transpose(1, 2),
                dv.transpose(1, 2), None)
