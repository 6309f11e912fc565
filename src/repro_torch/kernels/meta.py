"""The kernels' meta path: shapes, FLOPs and sharding without running them.

The dry run (``launch/dryrun.py``) runs every step on meta tensors. There
the five compute entries of ``kernels/ops.py`` (``flash_attention``,
``mamba_scan``, ``mamba_scan_fused``, ``rglru_scan``, ``rglru_scan_gated``)
call the ``ckio_meta::*`` ops of this module instead of a kernel or its
plain version (the plain versions loop over S in Python: at 32k tokens that
is millions of dispatches). Each op has

* a fake implementation, which gives the outputs' shapes and dtypes and is
  what runs on meta tensors (the real implementation raises: these ops
  never run on data);
* a FLOP formula (``torch.utils.flop_counter``): the tensor-contraction
  FLOPs that the reference's lowered program counts for the same function
  in its ``dot_general`` ops — attention's QK^T and PV over the full Sq×Sk
  (4·B·H·Sq·Sk·hd; no causal half), the selective scan's readout
  ``einsum("bsin,bsn->bsi", h, C)`` (2·B·S·D·N); the RG-LRU recurrence is
  elementwise and counts 0. Bytes are counted by the dry run's byte
  counter from each op's operands and results, like any aten op;
* an autograd formula whose backward is another meta op (twice the
  forward's FLOPs: the two products of each contraction's gradient), so
  that a train step on meta differentiates through them;
* a DTensor sharding rule (:func:`register_dtensor_rules`, applied by the
  dry run before its DTensor pass): batch or heads for attention, batch or
  channels for the scans, else everything replicated.

:func:`formula_flops` gives the same counts from shapes, for a caller that
launched a kernel (which aten does not see) and wants to add its count.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula


def _refuse(*_a, **_k):
    raise RuntimeError("ckio_meta ops run on meta tensors only (the dry "
                       "run's path); ops.py dispatches real tensors to the "
                       "kernels or their plain versions")


def check_meta(name: str, tensors: Sequence[Optional[Tensor]]) -> None:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds != {"meta"}:
        raise ValueError(f"{name}: kernel inputs on unsupported or mixed "
                         f"devices: {sorted(kinds)}")


def _none(h0: Optional[Tensor], like: Tensor) -> Tensor:
    """A 0-element stand-in for an absent state (no bytes, no FLOPs)."""
    return like.new_empty((0,)) if h0 is None else torch.empty_like(h0)


# -- attention ---------------------------------------------------------------------
@custom_op("ckio_meta::flash_attention", mutates_args=())
def _fa(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int) -> Tensor:
    _refuse()


@_fa.register_fake
def _(q, k, v, causal, window):
    return q.new_empty((*q.shape[:3], v.shape[3]))


@custom_op("ckio_meta::flash_attention_backward", mutates_args=())
def _fa_bwd(g: Tensor, q: Tensor, k: Tensor, v: Tensor, causal: bool,
            window: int) -> Tuple[Tensor, Tensor, Tensor]:
    _refuse()


@_fa_bwd.register_fake
def _(g, q, k, v, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _fa_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _fa_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = _fa_bwd(g, q, k, v, ctx.causal, ctx.window)
    return dq, dk, dv, None, None


_fa.register_autograd(_fa_backward, setup_context=_fa_setup)


def attention_flops(q_shape, k_shape, v_shape) -> int:
    """QK^T and PV over every (query, key) pair: 4·B·H·Sq·Sk·hd."""
    B, Sq, H, hd = q_shape
    return 2 * B * H * Sq * k_shape[1] * (hd + v_shape[3])


@register_flop_formula(torch.ops.ckio_meta.flash_attention)
def _fa_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kw) -> int:
    return attention_flops(q_shape, k_shape, v_shape)


@register_flop_formula(torch.ops.ckio_meta.flash_attention_backward)
def _fa_bwd_flops(g_shape, q_shape, k_shape, v_shape, *args, out_shape=None,
                  **kw) -> int:
    return 2 * attention_flops(q_shape, k_shape, v_shape)


def flash_attention(q, k, v, *, causal: bool, window: int) -> Tensor:
    check_meta("flash_attention", (q, k, v))
    return _fa(q, k, v, causal, window)


# -- the literal selective scan ------------------------------------------------------
@custom_op("ckio_meta::mamba_scan", mutates_args=())
def _ms(Abar: Tensor, Bx: Tensor, C: Tensor, h0: Optional[Tensor],
        return_state: bool) -> Tuple[Tensor, Tensor]:
    _refuse()


def _scan_out(x_bsd: Tensor, n: int, return_state: bool):
    B, S, D = x_bsd.shape[:3]
    y = x_bsd.new_empty((B, S, D), dtype=torch.float32)
    h = (x_bsd.new_empty((B, D, n), dtype=torch.float32) if return_state
         else x_bsd.new_empty((0,), dtype=torch.float32))
    return y, h


@_ms.register_fake
def _(Abar, Bx, C, h0, return_state):
    return _scan_out(Abar, Abar.shape[3], return_state)


@custom_op("ckio_meta::mamba_scan_backward", mutates_args=())
def _ms_bwd(gy: Tensor, Abar: Tensor, Bx: Tensor, C: Tensor,
            h0: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    _refuse()


@_ms_bwd.register_fake
def _(gy, Abar, Bx, C, h0):
    return (torch.empty_like(Abar), torch.empty_like(Bx), torch.empty_like(C),
            _none(h0, Abar))


def _one_grad(ctx, grads):
    """The gradient of the first output; a gradient through the returned
    state is not modelled (no caller's loss reads it)."""
    if any(g is not None for g in grads[1:]):
        raise NotImplementedError("ckio_meta: a gradient through a scan's "
                                  "returned state")
    return grads[0]


def _ms_setup(ctx, inputs, output):
    Abar, Bx, C, h0, _ = inputs
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(Abar, Bx, C, *((h0,) if ctx.has_h0 else ()))
    ctx.set_materialize_grads(False)


def _ms_backward(ctx, gy, gh):
    gy = _one_grad(ctx, (gy, gh))
    Abar, Bx, C, *h0 = ctx.saved_tensors
    h0 = h0[0] if h0 else None
    dA, dB, dC, dh0 = _ms_bwd(gy, Abar, Bx, C, h0)
    return dA, dB, dC, (dh0 if ctx.has_h0 else None), None


_ms.register_autograd(_ms_backward, setup_context=_ms_setup)


def scan_readout_flops(B: int, S: int, D: int, N: int) -> int:
    """``y = einsum("bsin,bsn->bsi", h, C)``: 2·B·S·D·N."""
    return 2 * B * S * D * N


@register_flop_formula(torch.ops.ckio_meta.mamba_scan)
def _ms_flops(a_shape, *args, out_shape=None, **kw) -> int:
    return scan_readout_flops(*a_shape)


@register_flop_formula(torch.ops.ckio_meta.mamba_scan_backward)
def _ms_bwd_flops(gy_shape, a_shape, *args, out_shape=None, **kw) -> int:
    return 2 * scan_readout_flops(*a_shape)


def mamba_scan(Abar, Bx, C, *, h0=None, return_state: bool = False):
    check_meta("mamba_scan", (Abar, Bx, C, h0))
    y, h = _ms(Abar, Bx, C, h0, return_state)
    return (y, h) if return_state else y


# -- the fused selective scan ----------------------------------------------------
@custom_op("ckio_meta::mamba_scan_fused", mutates_args=())
def _msf(xin: Tensor, dt_pre: Tensor, dt_bias: Tensor, A_log: Tensor,
         proj: Tensor, Dskip: Tensor, z: Tensor, h0: Optional[Tensor],
         return_state: bool) -> Tuple[Tensor, Tensor]:
    _refuse()


@_msf.register_fake
def _(xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0, return_state):
    y, h = _scan_out(xin, A_log.shape[1], return_state)
    return y.to(xin.dtype), h


@custom_op("ckio_meta::mamba_scan_fused_backward", mutates_args=())
def _msf_bwd(gy: Tensor, xin: Tensor, dt_pre: Tensor, dt_bias: Tensor,
             A_log: Tensor, proj: Tensor, Dskip: Tensor, z: Tensor,
             h0: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor,
                                        Tensor, Tensor, Tensor]:
    _refuse()


@_msf_bwd.register_fake
def _(gy, xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0):
    return (*(torch.empty_like(t) for t in
              (xin, dt_pre, dt_bias, A_log, proj, Dskip, z)), _none(h0, xin))


def _msf_setup(ctx, inputs, output):
    *ts, h0, _ = inputs
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(*ts, *((h0,) if ctx.has_h0 else ()))
    ctx.set_materialize_grads(False)


def _msf_backward(ctx, gy, gh):
    gy = _one_grad(ctx, (gy, gh))
    saved = ctx.saved_tensors
    h0 = saved[7] if ctx.has_h0 else None
    grads = _msf_bwd(gy, *saved[:7], h0)
    return (*grads[:7], grads[7] if ctx.has_h0 else None, None)


_msf.register_autograd(_msf_backward, setup_context=_msf_setup)


@register_flop_formula(torch.ops.ckio_meta.mamba_scan_fused)
def _msf_flops(xin_shape, dt_shape, bias_shape, a_shape, *args,
               out_shape=None, **kw) -> int:
    B, S, D = xin_shape
    return scan_readout_flops(B, S, D, a_shape[1])


@register_flop_formula(torch.ops.ckio_meta.mamba_scan_fused_backward)
def _msf_bwd_flops(gy_shape, xin_shape, dt_shape, bias_shape, a_shape, *args,
                   out_shape=None, **kw) -> int:
    B, S, D = xin_shape
    return 2 * scan_readout_flops(B, S, D, a_shape[1])


def mamba_scan_fused(xin, dt_pre, dt_bias, A_log, proj, Dskip, z, *,
                     h0=None, return_state: bool = False):
    check_meta("mamba_scan_fused",
               (xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0))
    y, h = _msf(xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0, return_state)
    return (y, h) if return_state else y


# -- the RG-LRU recurrence, literal and gated ---------------------------------------
@custom_op("ckio_meta::rglru_scan", mutates_args=())
def _lru(a: Tensor, b: Tensor, h0: Optional[Tensor]) -> Tensor:
    _refuse()


@_lru.register_fake
def _(a, b, h0):
    return torch.empty_like(a)


@custom_op("ckio_meta::rglru_scan_backward", mutates_args=())
def _lru_bwd(g: Tensor, a: Tensor, b: Tensor, h0: Optional[Tensor]
             ) -> Tuple[Tensor, Tensor, Tensor]:
    _refuse()


@_lru_bwd.register_fake
def _(g, a, b, h0):
    return torch.empty_like(a), torch.empty_like(b), _none(h0, a)


def _lru_setup(ctx, inputs, output):
    a, b, h0 = inputs
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(a, b, *((h0,) if ctx.has_h0 else ()))


def _lru_backward(ctx, g):
    a, b, *h0 = ctx.saved_tensors
    da, db, dh0 = _lru_bwd(g, a, b, h0[0] if h0 else None)
    return da, db, (dh0 if ctx.has_h0 else None)


_lru.register_autograd(_lru_backward, setup_context=_lru_setup)


@custom_op("ckio_meta::rglru_scan_gated", mutates_args=())
def _lrug(r_pre: Tensor, i_pre: Tensor, b_r: Tensor, b_i: Tensor, lam: Tensor,
          xr: Tensor, gate: Tensor, h0: Optional[Tensor],
          return_state: bool) -> Tuple[Tensor, Tensor]:
    _refuse()


@_lrug.register_fake
def _(r_pre, i_pre, b_r, b_i, lam, xr, gate, h0, return_state):
    B, S, W = xr.shape
    h = (r_pre.new_empty((B, W)) if return_state else r_pre.new_empty((0,)))
    return torch.empty_like(gate), h


@custom_op("ckio_meta::rglru_scan_gated_backward", mutates_args=())
def _lrug_bwd(gy: Tensor, r_pre: Tensor, i_pre: Tensor, b_r: Tensor,
              b_i: Tensor, lam: Tensor, xr: Tensor, gate: Tensor,
              h0: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                             Tensor, Tensor, Tensor, Tensor]:
    _refuse()


@_lrug_bwd.register_fake
def _(gy, r_pre, i_pre, b_r, b_i, lam, xr, gate, h0):
    return (*(torch.empty_like(t) for t in
              (r_pre, i_pre, b_r, b_i, lam, xr, gate)), _none(h0, r_pre))


def _lrug_setup(ctx, inputs, output):
    *ts, h0, _ = inputs
    ctx.has_h0 = h0 is not None
    ctx.save_for_backward(*ts, *((h0,) if ctx.has_h0 else ()))
    ctx.set_materialize_grads(False)


def _lrug_backward(ctx, gy, gh):
    gy = _one_grad(ctx, (gy, gh))
    saved = ctx.saved_tensors
    h0 = saved[7] if ctx.has_h0 else None
    grads = _lrug_bwd(gy, *saved[:7], h0)
    return (*grads[:7], grads[7] if ctx.has_h0 else None, None)


_lrug.register_autograd(_lrug_backward, setup_context=_lrug_setup)


@register_flop_formula([torch.ops.ckio_meta.rglru_scan,
                        torch.ops.ckio_meta.rglru_scan_backward,
                        torch.ops.ckio_meta.rglru_scan_gated,
                        torch.ops.ckio_meta.rglru_scan_gated_backward])
def _lru_flops(*args, out_shape=None, **kw) -> int:
    return 0          # elementwise: the reference's program has no dot_general


def rglru_scan(a, b, *, h0=None) -> Tensor:
    check_meta("rglru_scan", (a, b, h0))
    return _lru(a, b, h0)


def rglru_scan_gated(r_pre, i_pre, b_r, b_i, lam, xr, gate, *, h0=None,
                     return_state: bool = False):
    check_meta("rglru_scan_gated", (r_pre, i_pre, b_r, b_i, lam, xr, gate, h0))
    y, h = _lrug(r_pre, i_pre, b_r, b_i, lam, xr, gate, h0, return_state)
    return (y, h) if return_state else y


# -- the loss's gold logit ------------------------------------------------------------
@custom_op("ckio_meta::take_labels", mutates_args=())
def _take(shifted: Tensor, labels: Tensor) -> Tensor:
    _refuse()


@_take.register_fake
def _(shifted, labels):
    return shifted.new_empty(shifted.shape[:-1])


@custom_op("ckio_meta::take_labels_backward", mutates_args=())
def _take_bwd(g: Tensor, shifted: Tensor, labels: Tensor) -> Tensor:
    _refuse()


@_take_bwd.register_fake
def _(g, shifted, labels):
    return torch.empty_like(shifted)


def _take_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _take_backward(ctx, g):
    shifted, labels = ctx.saved_tensors
    return _take_bwd(g, shifted, labels), None


_take.register_autograd(_take_backward, setup_context=_take_setup)


def take_labels(shifted: Tensor, labels: Tensor) -> Tensor:
    """``softmax_xent``'s gold logit on meta: ``shifted[b, s, labels[b,
    s]]``, (B, S), the function of its ``gather``. GSPMD runs it on
    vocab-sharded logits as a masked gather and a partial sum (and its
    gradient as a masked scatter); DTensor's own gather cannot, so the dry
    run takes this op, whose sharding rule says so."""
    check_meta("take_labels", (shifted, labels))
    return _take(shifted, labels)


# -- the embedding lookup -------------------------------------------------------------
@custom_op("ckio_meta::embedding", mutates_args=())
def _emb(ids: Tensor, table: Tensor) -> Tensor:
    _refuse()


@_emb.register_fake
def _(ids, table):
    return table.new_empty((*ids.shape, table.shape[1]))


@custom_op("ckio_meta::embedding_backward", mutates_args=())
def _emb_bwd(g: Tensor, ids: Tensor, rows: Tensor) -> Tensor:
    _refuse()


@_emb_bwd.register_fake
def _(g, ids, rows):
    return g.new_empty((rows.shape[0], g.shape[-1]))


def _emb_setup(ctx, inputs, output):
    ids, table = inputs
    # the table's first column stands for its rows (a sharded table's
    # shard has its own), without counting the table as read
    ctx.save_for_backward(ids, table[:, 0])


def _emb_backward(ctx, g):
    ids, rows = ctx.saved_tensors
    return None, _emb_bwd(g, ids, rows)


_emb.register_autograd(_emb_backward, setup_context=_emb_setup)


def embedding(ids: Tensor, table: Tensor) -> Tensor:
    """``F.embedding`` on meta: rows of ``table`` (V, d) at ``ids``. GSPMD
    runs it on a vocab-sharded table as a masked gather and a partial sum
    (its gradient as a masked scatter); DTensor's own rule gives a masked
    partial that cannot meet the tied unembedding's plain partial in the
    table's gradient, so the dry run takes this op."""
    check_meta("embedding", (ids, table))
    return _emb(ids, table)


# -- the depthwise causal conv ---------------------------------------------------------
@custom_op("ckio_meta::causal_conv", mutates_args=())
def _conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    _refuse()


@_conv.register_fake
def _(x, w, b):
    return torch.empty_like(x)


@custom_op("ckio_meta::causal_conv_backward", mutates_args=())
def _conv_bwd(g: Tensor, x: Tensor, w: Tensor, b: Tensor
              ) -> Tuple[Tensor, Tensor, Tensor]:
    _refuse()


@_conv_bwd.register_fake
def _(g, x, w, b):
    return torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)


def _conv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _conv_backward(ctx, g):
    return _conv_bwd(g, *ctx.saved_tensors)


_conv.register_autograd(_conv_backward, setup_context=_conv_setup)


def conv_flops(x_shape, w_shape) -> int:
    """``F.conv1d`` over (B, c, S) with groups=c, as torch counts it:
    2·B·S·c·cw."""
    B, S, c = x_shape
    return 2 * B * S * c * w_shape[0]


@register_flop_formula(torch.ops.ckio_meta.causal_conv)
def _conv_flops(x_shape, w_shape, *args, out_shape=None, **kw) -> int:
    return conv_flops(x_shape, w_shape)


@register_flop_formula(torch.ops.ckio_meta.causal_conv_backward)
def _conv_bwd_flops(g_shape, x_shape, w_shape, *args, out_shape=None,
                    **kw) -> int:
    return 2 * conv_flops(x_shape, w_shape)


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """``layers.causal_conv`` on meta: x (B, S, c), w (cw, c), b (c,), the
    FLOPs that ``F.conv1d`` with groups=c counts, and a DTensor rule that
    shards batch or channels (DTensor's convolution rule keeps ``groups``
    when it shards channels, which a depthwise conv cannot)."""
    check_meta("causal_conv", (x, w, b))
    return _conv(x, w, b)


# -- counts for launched kernels ------------------------------------------------------
def formula_flops(name: str, *shapes) -> int:
    """The FLOP formula of kernel ``name`` (an ``ops`` entry) from its
    inputs' shapes, in the entry's argument order: what the meta path
    counts for one launch."""
    if name == "flash_attention":
        return attention_flops(*shapes[:3])
    if name == "mamba_scan":
        return scan_readout_flops(*shapes[0])
    if name == "mamba_scan_fused":
        B, S, D = shapes[0]
        return scan_readout_flops(B, S, D, shapes[3][1])
    if name in ("rglru_scan", "rglru_scan_gated"):
        return 0
    raise KeyError(name)


# -- DTensor sharding rules ----
aten = torch.ops.aten


def _rowwise(*args, **kwargs):
    """Every tensor argument and result sharded on dim 0, or all
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [([Replicate()], [Replicate() if hasattr(a, "shape") else None
                             for a in args]),
            ([Shard(0)], [Shard(0) if hasattr(a, "shape") else None
                          for a in args])]


_RULES_DONE = []


def _strategies(dims: Sequence[Sequence[Optional[int]]], out_dims, args,
                state: bool = True):
    """Acceptable (outputs, inputs) placements: everything replicated, and
    for each alternative k, tensor i sharded on ``dims[k][i]`` (None:
    replicated) with output j on ``out_dims[k][j]``. Non-tensor and absent
    arguments get None. ``state=False``: the last output is the 0-element
    stand-in of an absent state, always replicated."""
    from torch.distributed.tensor import Replicate, Shard

    if not state:
        out_dims = [tuple(o[:-1]) + (None,) for o in out_dims]

    def place(d):
        return Replicate() if d is None else Shard(d)

    is_t = [a is not None and hasattr(a, "shape") for a in args]
    n_out = len(out_dims[0])
    out = [([Replicate()] * n_out,
            [Replicate() if t else None for t in is_t])]
    for ins, outs in zip(dims, out_dims):
        out.append(([place(d) for d in outs],
                    [place(d) if t else None for d, t in zip(ins, is_t)]))
    return out


def register_dtensor_rules() -> None:
    """Register each meta op's sharding rule with DTensor (once)."""
    if _RULES_DONE:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    ops = torch.ops.ckio_meta
    pad = (None, None)          # trailing non-tensor arguments

    # flash attention, (B, S, H, hd): batch or heads
    @register_sharding(ops.flash_attention.default)
    def _(q, k, v, causal, window):
        return _strategies([(0, 0, 0) + pad, (2, 2, 2) + pad],
                           [(0,), (2,)], (q, k, v, causal, window))

    @register_sharding(ops.flash_attention_backward.default)
    def _(g, q, k, v, causal, window):
        return _strategies([(0, 0, 0, 0) + pad, (2, 2, 2, 2) + pad],
                           [(0, 0, 0), (2, 2, 2)], (g, q, k, v, causal, window))

    # literal scan: Abar, Bx (B, S, D, N), C (B, S, N), h0 (B, D, N)
    @register_sharding(ops.mamba_scan.default)
    def _(Abar, Bx, C, h0, rs):
        return _strategies([(0, 0, 0, 0, None), (2, 2, None, 1, None)],
                           [(0, 0), (2, 1)], (Abar, Bx, C, h0, rs), rs)

    @register_sharding(ops.mamba_scan_backward.default)
    def _(gy, Abar, Bx, C, h0):
        return _strategies([(0, 0, 0, 0, 0), (2, 2, 2, None, 1)],
                           [(0, 0, 0, 0), (2, 2, None, 1)],
                           (gy, Abar, Bx, C, h0), h0 is not None)

    # fused scan: xin, dt_pre, z (B, S, D); dt_bias, Dskip (D); A_log (D, N);
    # proj (B, S, r+2N); h0 (B, D, N)
    @register_sharding(ops.mamba_scan_fused.default)
    def _(xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0, rs):
        return _strategies(
            [(0, 0, None, None, 0, None, 0, 0, None),
             (2, 2, 0, 0, None, 0, 2, 1, None)],
            [(0, 0), (2, 1)], (xin, dt_pre, dt_bias, A_log, proj, Dskip, z,
                               h0, rs), rs)

    @register_sharding(ops.mamba_scan_fused_backward.default)
    def _(gy, xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0):
        return _strategies(
            [(0, 0, 0, None, None, 0, None, 0, 0),
             (2, 2, 2, 0, 0, None, 0, 2, 1)],
            [(0, 0, None, None, 0, None, 0, 0),
             (2, 2, 0, 0, None, 0, 2, 1)],
            (gy, xin, dt_pre, dt_bias, A_log, proj, Dskip, z, h0),
            h0 is not None)

    # RG-LRU: a, b (B, S, W), h0 (B, W)
    @register_sharding(ops.rglru_scan.default)
    def _(a, b, h0):
        return _strategies([(0, 0, 0), (2, 2, 1)], [(0,), (2,)], (a, b, h0))

    @register_sharding(ops.rglru_scan_backward.default)
    def _(g, a, b, h0):
        return _strategies([(0, 0, 0, 0), (2, 2, 2, 1)],
                           [(0, 0, 0), (2, 2, 1)], (g, a, b, h0),
                           h0 is not None)

    # gated: r_pre, i_pre, xr, gate (B, S, W); b_r, b_i, lam (W); h0 (B, W)
    @register_sharding(ops.rglru_scan_gated.default)
    def _(r_pre, i_pre, b_r, b_i, lam, xr, gate, h0, rs):
        return _strategies(
            [(0, 0, None, None, None, 0, 0, 0, None),
             (2, 2, 0, 0, 0, 2, 2, 1, None)],
            [(0, 0), (2, 1)], (r_pre, i_pre, b_r, b_i, lam, xr, gate, h0, rs),
            rs)

    @register_sharding(ops.rglru_scan_gated_backward.default)
    def _(gy, r_pre, i_pre, b_r, b_i, lam, xr, gate, h0):
        return _strategies(
            [(0, 0, 0, None, None, None, 0, 0, 0),
             (2, 2, 2, 0, 0, 0, 2, 2, 1)],
            [(0, 0, None, None, None, 0, 0, 0),
             (2, 2, 0, 0, 0, 2, 2, 1)],
            (gy, r_pre, i_pre, b_r, b_i, lam, xr, gate, h0),
            h0 is not None)

    # the embedding, ids (B, S), table (V, d): batch, or vocab (each shard
    # takes the rows it holds: a partial sum; its gradient the rows it holds)
    @register_sharding(ops.embedding.default)
    def _(ids, table):
        return [([Replicate()], [Replicate(), Replicate()]),
                ([Shard(0)], [Shard(0), Replicate()]),
                ([Partial()], [Replicate(), Shard(0)])]

    @register_sharding(ops.embedding_backward.default)
    def _(g, ids, rows):
        return [([Replicate()], [Replicate(), Replicate(), Replicate()]),
                ([Partial()], [Shard(0), Shard(0), Replicate()]),
                ([Shard(0)], [Replicate(), Replicate(), Shard(0)])]

    # the gold logit, shifted (B, S, V), labels (B, S): batch, or vocab
    # (each shard takes the labels it holds: a partial sum)
    @register_sharding(ops.take_labels.default)
    def _(shifted, labels):
        return [([Replicate()], [Replicate(), Replicate()]),
                ([Shard(0)], [Shard(0), Shard(0)]),
                ([Partial()], [Shard(2), Replicate()])]

    @register_sharding(ops.take_labels_backward.default)
    def _(g, shifted, labels):
        return [([Replicate()], [Replicate(), Replicate(), Replicate()]),
                ([Shard(0)], [Shard(0), Shard(0), Shard(0)]),
                ([Shard(2)], [Replicate(), Shard(2), Replicate()])]

    # depthwise causal conv: x (B, S, c), w (cw, c), b (c,)
    @register_sharding(ops.causal_conv.default)
    def _(x, w, b):
        return _strategies([(0, None, None), (2, 1, 0)], [(0,), (2,)],
                           (x, w, b))

    @register_sharding(ops.causal_conv_backward.default)
    def _(g, x, w, b):
        return [([Replicate()] * 3, [Replicate()] * 4),
                ([Shard(0), Partial(), Partial()],
                 [Shard(0), Shard(0), Replicate(), Replicate()]),
                ([Shard(2), Shard(1), Shard(0)],
                 [Shard(2), Shard(2), Shard(1), Shard(0)])]

    # ops of the MoE routing without a DTensor rule: each works a batch row
    # at a time (routing is per row), so batch sharding is exact
    for op in (aten.searchsorted.Tensor,):
        register_sharding(op)(_rowwise)

    _RULES_DONE.append(True)
