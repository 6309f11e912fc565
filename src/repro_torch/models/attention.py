"""Attention: GQA/MQA/MHA with causal and sliding-window masks; the KV
cache for decode.

The train/prefill half is the reference's XLA path
(``repro/models/attention.py``): scores in fp32, probabilities cast back to
the compute dtype before the PV product. Where autograd records a causal
attention on plain CUDA tensors in bf16, with no softcap and a head size
the kernels take, ``attention_train`` computes the same function through
``ops.flash_attention_train`` instead: the hand-written training forward
and backward, which keep the scores in fp32 on chip and never write them
(the probabilities are rounded to bf16 as the PV operand, as here). Every
other call keeps ``_sdpa``: the CPU, meta tensors and DTensors (the dry
run), a softcap, fp32, and the no-grad prefill of ``forward_logits``.

Decode departs from the reference on purpose: its attention goes through
``ops.flash_attention`` (the hand-written kernel on CUDA tensors, the plain
version on CPU tensors) over the cache slots that hold positions, where the
reference runs ``_sdpa`` over the whole ring with a slot mask. Both write
the new token at slot ``pos % C`` of a ring of C slots. While ``pos < C``
the valid slots are exactly ``0..pos`` and the slot mask equals the
kernel's end-aligned causal (and window) mask over ``k[:, :pos+1]``. Once
``pos >= C`` every slot holds one of the last C positions, and the
reference's mask (``slot_pos <= pos`` and ``pos - slot_pos < window``)
keeps all C of them, because a ring is never larger than its layer's
window (``transformer._layer_capacity``) or the layer has none: the kernel
then attends over all C slots with no window (with one query the causal
mask keeps every key). The layer's window must not be passed on a rotated
ring, where the kernel would mask by slot index instead of position. So
both compute the same function (the reference rounds the probabilities to
the compute dtype before PV; the kernel keeps them in fp32, and sums the
keys in slot order).

The encoder-decoder's unmasked attention (``bidirectional_attention``, an
encoder's self-attention; ``cross_attention`` over precomputed
``cross_kv``) takes ``kernel``: through ``ops.flash_attention(causal=False)``
where the reference runs ``_sdpa(mask=None)``, the same function, or
through ``_sdpa`` itself where autograd must differentiate it: the loss
and the prefill forward pass ``kernel=False``, the encoder at admission
and decode ``kernel=True`` (``models/encdec.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, fan_in_init, rmsnorm, rmsnorm_init, shard_act

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    """A ring of C slots: slot ``s`` holds the largest position ``p <
    pos`` with ``p % C == s``. That follows from ``pos`` alone, so the
    reference's ``slot_pos`` is not kept."""
    k: torch.Tensor          # (B, C, K, hd)
    v: torch.Tensor          # (B, C, K, hd)


def init_cache(batch: int, capacity: int, kv_heads: int, head_dim: int,
               dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, kv_heads, head_dim), dtype=dtype,
                      device=device),
    )


def attn_init(gen, d: int, heads: int, kv_heads: int, head_dim: int, dtype,
              device, bias: bool = False, qk_norm: bool = False,
              phys_heads: int = 0, phys_kv: int = 0) -> dict:
    """``phys_heads``/``phys_kv`` pad (H, K) to TP-divisible physical counts
    with the same G = H/K (e.g. phi4's (24, 8) -> (48, 16)), as the
    reference's ``attn_init`` does. Padded slices are zero: padded q, k and
    v project to zero, their heads' attention output is exactly zero and
    ``wo``'s padded rows are zero, so the padded model computes the real
    one's function, and gradients into padded slices vanish. Query head h
    reads kv head h // G, so the padded query heads read only padded kv
    heads."""
    H = phys_heads or heads
    K = phys_kv or kv_heads
    if phys_heads or phys_kv:
        if not (H % K == 0 and H // K == heads // kv_heads
                and H >= heads and K >= kv_heads):
            raise ValueError(f"padding must preserve the GQA ratio: "
                             f"({heads},{kv_heads}) -> ({H},{K})")
    p = {
        "wq": fan_in_init(gen, (d, H, head_dim), d, dtype, device),
        "wk": fan_in_init(gen, (d, K, head_dim), d, dtype, device),
        "wv": fan_in_init(gen, (d, K, head_dim), d, dtype, device),
        "wo": fan_in_init(gen, (H, head_dim, d), heads * head_dim, dtype,
                          device),
    }
    if H > heads:
        p["wq"][:, heads:] = 0.0
        p["wo"][heads:] = 0.0
    if K > kv_heads:
        p["wk"][:, kv_heads:] = 0.0
        p["wv"][:, kv_heads:] = 0.0
    if bias:
        p["bq"] = torch.zeros((H, head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K, head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K, head_dim), dtype=dtype, device=device)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, dtype, device)
        p["k_norm"] = rmsnorm_init(head_dim, dtype, device)
    return p


def _project_qkv(params: dict, x: torch.Tensor, dtype, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dtype))
    if "bq" in params:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q, eps)
        k = rmsnorm(params["k_norm"], k, eps)
    return q, k, v


def _sdpa(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, K, hd)
    v: torch.Tensor,            # (B, Sk, K, hd)
    *,
    mask: Optional[torch.Tensor],   # broadcastable to (B, K, G, Sq, Sk)
    softcap: float = 0.0,
) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k) * scale
    scores = scores.float()
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, hd)


def causal_window_mask(sq: int, sk: int, window: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """(1,1,1,Sq,Sk) bool: j <= i+offset and (window==0 or i+offset-j < window)."""
    i = torch.arange(sq, device=device)[:, None] + offset
    j = torch.arange(sk, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= (i - j) < window
    return m[None, None, None]


def _chunked_sdpa(q, k, v, *, causal: bool, window: int, softcap: float,
                  q_chunk: int) -> torch.Tensor:
    """q-chunked attention: the live score tensor is (B, K, G, q_chunk, S),
    and each chunk is recomputed in the backward pass (activation
    checkpointing), so activation memory is one chunk."""
    B, S, H, hd = q.shape
    nc = S // q_chunk

    def one_chunk(qs, k, v, i: int):
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)[:, None]
        kpos = torch.arange(S, device=q.device)[None, :]
        m = torch.ones((q_chunk, S), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos <= qpos
        if window > 0:
            m &= (qpos - kpos) < window
        return _sdpa(qs, k, v, mask=m[None, None, None], softcap=softcap)

    outs = [
        checkpoint(one_chunk, q[:, i * q_chunk:(i + 1) * q_chunk], k, v, i,
                   use_reentrant=False)
        for i in range(nc)
    ]
    return torch.cat(outs, dim=1)


def _trains_through_kernels(q, k, v, *, causal: bool, softcap: float) -> bool:
    """Whether ``attention_train`` takes ``ops.flash_attention_train``:
    from what the call shows (tensor type, device, dtype, head size, mask,
    softcap, grad mode), never from a model's name."""
    return (causal and softcap == 0.0 and torch.is_grad_enabled()
            and q.shape[-1] in FA.TRAIN_HEAD_DIMS
            and all(type(t) is torch.Tensor and t.device.type == "cuda"
                    and t.dtype == torch.bfloat16 for t in (q, k, v)))


def attention_train(
    params: dict,
    x: torch.Tensor,               # (B, S, d)
    cos: torch.Tensor, sin: torch.Tensor,
    *,
    dtype,
    eps: float,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    use_rope: bool = True,
    q_chunk: int = 0,
) -> torch.Tensor:
    q, k, v = _project_qkv(params, x, dtype, eps)
    if use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = shard_act(q, "batch", None, "model", None)
    k = shard_act(k, "batch", None, "model", None)
    v = shard_act(v, "batch", None, "model", None)
    S = x.shape[1]
    if _trains_through_kernels(q, k, v, causal=causal, softcap=softcap):
        out = ops.flash_attention_train(q, k, v, window=window)
    elif q_chunk and S > q_chunk and S % q_chunk == 0 and causal:
        out = _chunked_sdpa(q, k, v, causal=causal, window=window,
                            softcap=softcap, q_chunk=q_chunk)
    else:
        mask = (causal_window_mask(S, S, window, device=x.device)
                if causal else None)
        out = _sdpa(q, k, v, mask=mask, softcap=softcap)
    out = shard_act(out, "batch", None, "model", None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))


def cross_kv(params: dict, enc: torch.Tensor, dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of the encoder output ``enc``
    (B, Sk, d): each (B, Sk, K, hd), biases included."""
    k = torch.einsum("bsd,dhk->bshk", enc, params["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", enc, params["wv"].to(dtype))
    if "bk" in params:
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return k, v


def _unmasked(q, k, v, kernel: bool) -> torch.Tensor:
    """Attention with no mask: through ``ops.flash_attention(causal=False)``
    (the hand-written kernel on CUDA tensors, which reads q, k and v in
    place; the plain version on CPU ones) with ``kernel``, else the
    reference's ``_sdpa`` (differentiable: the kernel is forward-only)."""
    if kernel:
        return ops.flash_attention(q, k, v, causal=False)
    return _sdpa(q, k, v, mask=None)


def bidirectional_attention(params: dict, x: torch.Tensor, *, dtype,
                            eps: float, kernel: bool) -> torch.Tensor:
    """An encoder's self-attention over ``x`` (B, S, d): every position
    sees every other, no rotary embedding (the reference's
    ``attention_train(causal=False)`` under its identity rotation)."""
    q, k, v = _project_qkv(params, x, dtype, eps)
    out = _unmasked(q, k, v, kernel)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))


def cross_attention(
    params: dict,
    x: torch.Tensor,                       # (B, Sq, d) decoder side
    kv_src: Tuple[torch.Tensor, torch.Tensor],  # (k, v): (B, Sk, K, hd)
    *,
    dtype,
    kernel: bool,
) -> torch.Tensor:
    """Decoder queries over precomputed encoder keys and values, no
    mask."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dtype))
    if "bq" in params:
        q = q + params["bq"].to(dtype)
    k, v = kv_src
    out = _unmasked(q, k, v, kernel)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))


def prefill_cache(
    params: dict,
    x: torch.Tensor,               # (B, S, d)
    cos: torch.Tensor, sin: torch.Tensor,
    capacity: int,
    *,
    dtype,
    eps: float,
    use_rope: bool = True,
) -> KVCache:
    """A decode cache from a full prefill pass over ``x`` (positions 0 ..
    S-1): the ring ``attention_decode`` would hold after those S steps,
    slot ``pos % capacity``. With ``capacity >= S`` slots 0 .. S-1 hold the
    positions and the rest are zero; with ``capacity < S`` the last
    ``capacity`` positions are kept, rolled so that each sits at its slot.
    The reference's ``prefill_cache`` without its ``slot_pos``, which
    follows from the position alone (:class:`KVCache`)."""
    _, k, v = _project_qkv(params, x, dtype, eps)
    if use_rope:
        k = apply_rope(k, cos, sin)
    S = x.shape[1]

    def ring(t: torch.Tensor) -> torch.Tensor:
        if capacity >= S:
            out = t.new_zeros((t.shape[0], capacity) + tuple(t.shape[2:]))
            out[:, :S] = t
            return out
        return torch.roll(t[:, S - capacity:], (S - capacity) % capacity,
                          dims=1).contiguous()

    return KVCache(k=ring(k).to(dtype), v=ring(v).to(dtype))


def attention_decode(
    params: dict,
    x: torch.Tensor,               # (B, 1, d) new token
    cache: KVCache,
    pos: int,                      # absolute position of the new token (host int)
    cos: torch.Tensor, sin: torch.Tensor,  # (B, 1, hd//2) for the new position
    *,
    dtype,
    eps: float,
    window: int = 0,
    softcap: float = 0.0,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step of one layer. Writes the new token's k/v into slot
    ``pos % C`` of ``cache`` and attends through ``ops.flash_attention``
    over slots ``0..pos`` (with the layer's window) while ``pos < C``, over
    all C slots (no window) once the ring has wrapped. The cache is updated
    in place (the reference returns a new one): the caller's cache and the
    returned one are the same tensors, which saves a copy of the cache per
    layer per token."""
    C = cache.k.shape[1]
    q, k_new, v_new = _project_qkv(params, x, dtype, eps)
    if use_rope:
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    slot = pos % C
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    if pos < C:
        out = ops.flash_attention(q, cache.k[:, :pos + 1],
                                  cache.v[:, :pos + 1], causal=True,
                                  window=window, softcap=softcap)
    elif 0 < window < C:
        raise ValueError(f"a ring of {C} slots wider than its window "
                         f"{window} cannot wrap: size local rings to the "
                         f"window (transformer._layer_capacity)")
    else:
        out = ops.flash_attention(q, cache.k, cache.v, causal=True, window=0,
                                  softcap=softcap)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dtype))
    return out, cache
