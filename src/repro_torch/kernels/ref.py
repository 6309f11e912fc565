"""Plain PyTorch versions of the port's kernels: the ground truth the CUDA
kernels are held to (bit-exact for the reassembly gathers, within the
stated tolerance for attention and the two scans), and the path CPU
tensors take."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def attention_ref(
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Dense softmax attention, GQA by head-group folding, fp32 throughout;
    the output is cast to q's dtype. Causal positions are end-aligned
    (query i sits at i + Sk - Sq); the window applies to causal masks only,
    and a row with every key masked softmaxes over the -2e38 fill (uniform
    weights), as in the reference oracle."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (hd ** -0.5)
    if causal:
        i = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        j = torch.arange(Sk, device=q.device)[None, :]
        m = j <= i
        if window > 0:
            m &= (i - j) < window
        s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def attention_split_ref(
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """The split-key decode path written plainly: the key axis cut by
    ``flash_attention.split_plan``, the splits that ``split_range``
    launches each reduced to fp32 partials (max ``m``, denominator ``l``,
    unnormalised accumulator), then merged in split order with weights
    ``exp(m - max)``, a split whose max is the -2e38 fill weighing 0. A row
    with no kept key gives 0 (the denominator is clamped to 1e-30), as in
    the kernel and the Pallas kernel; ``attention_ref`` averages over the
    fill there instead."""
    from repro_torch.kernels.flash_attention import split_plan, split_range

    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    span, _ = split_plan(Sk, hd)
    first, last = split_range(Sq, Sk, span, window=window)
    k_begin = max(0, Sk - Sq - window + 1) if window > 0 else 0
    qf = q.reshape(B, K, G, Sq, hd).float()
    i = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    parts = []
    for s in range(first, last):
        a, b = max(s * span, k_begin), min(Sk, (s + 1) * span)
        if b <= a:
            parts.append((qf.new_full(qf.shape[:-1], NEG_INF),
                          qf.new_zeros(qf.shape[:-1]), torch.zeros_like(qf)))
            continue
        sc = torch.einsum("bkgqd,bksd->bkgqs", qf,
                          k[:, :, a:b].float()) * (hd ** -0.5)
        j = torch.arange(a, b, device=q.device)[None, :]
        keep = torch.ones((Sq, b - a), dtype=torch.bool, device=q.device)
        if causal:
            keep &= j <= i
        if window > 0:
            keep &= (i - j) < window
        sc = sc.masked_fill(~keep, NEG_INF)
        m = sc.amax(dim=-1)
        base = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
        p = torch.where(keep, torch.exp(sc - base[..., None]),
                        torch.zeros_like(sc))
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgqs,bksd->bkgqd", p, v[:, :, a:b].float())))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(qf)
    for m, l, a in parts:                   # split order
        w = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - mx))
        den = den + w * l
        acc = acc + w[..., None] * a
    o = acc / den.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def ssm_scan_ref(
    Abar: torch.Tensor,                   # (B, S, D, N) fp32
    Bx: torch.Tensor,                     # (B, S, D, N) fp32
    C: torch.Tensor,                      # (B, S, N) fp32
    h0: Optional[torch.Tensor] = None,    # (B, D, N) fp32
    *,
    return_state: bool = False,
):
    """``y_t = <h_t, C_t>``, ``h_t = Abar_t * h_{t-1} + Bx_t`` from ``h0``
    (zeros when None), a loop over S. Returns ``y`` (B, S, D), or
    ``(y, h_S)`` with the state after the last step."""
    B, S, D, N = Abar.shape
    h = Abar.new_zeros((B, D, N)) if h0 is None else h0
    ys = []
    for t in range(S):
        h = Abar[:, t] * h + Bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else Abar.new_zeros((B, 0, D))
    return (y, h) if return_state else y


def lru_scan_ref(
    a: torch.Tensor,                      # (B, S, W) fp32 decay
    b: torch.Tensor,                      # (B, S, W) fp32 input
    h0: Optional[torch.Tensor] = None,    # (B, W) fp32
) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` elementwise from ``h0`` (zeros when
    None), a loop over S. Returns every ``h`` (B, S, W)."""
    B, S, W = a.shape
    h = a.new_zeros((B, W)) if h0 is None else h0
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1) if hs else a.new_zeros((B, 0, W))


def mamba_scan_fused_ref(
    xin: torch.Tensor,                    # (B, S, D) compute dtype
    dt_pre: torch.Tensor,                 # (B, S, D) compute dtype
    dt_bias: torch.Tensor,                # (D,) fp32
    A_log: torch.Tensor,                  # (D, N) fp32
    proj: torch.Tensor,                   # (B, S, r+2N) compute dtype
    Dskip: torch.Tensor,                  # (D,) fp32
    z: torch.Tensor,                      # (B, S, D) compute dtype
    h0: Optional[torch.Tensor] = None,    # (B, D, N) fp32
    *,
    return_state: bool = False,
):
    """A Mamba-1 layer's discretization, selective scan and output
    epilogue: ``(ssm_scan(Abar, Bx, Cc) + D * xin) * silu(z)`` in the
    compute dtype of ``xin``, with torch's rounding at every op. Returns
    ``y`` (B, S, D), or ``(y, h_S)`` with the fp32 state after the last
    step. ``Bc``, ``Cc`` are the last 2N columns of the ``x_proj`` output
    ``proj``; ``dt`` goes through softplus in the compute dtype, then to
    fp32."""
    dtype = xin.dtype
    n = A_log.shape[1]
    r = proj.shape[-1] - 2 * n
    Bc, Cc = proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(dt_pre + dt_bias.to(dtype)).float()     # (B, S, D)
    A = -torch.exp(A_log.float())                           # (D, N)
    Abar = torch.exp(dt[..., None] * A)
    Bx = dt[..., None] * Bc[..., None, :].float() * xin[..., None].float()
    y, h = ssm_scan_ref(Abar, Bx, Cc.float(), h0, return_state=True)
    y = y.to(dtype)
    y = y + Dskip.to(dtype) * xin
    y = y * F.silu(z)
    return (y, h) if return_state else y


RGLRU_C = 8.0


def rglru_scan_gated_ref(
    r_pre: torch.Tensor,                  # (B, S, W) fp32
    i_pre: torch.Tensor,                  # (B, S, W) fp32
    b_r: torch.Tensor,                    # (W,) fp32
    b_i: torch.Tensor,                    # (W,) fp32
    lam: torch.Tensor,                    # (W,) fp32
    xr: torch.Tensor,                     # (B, S, W) compute dtype
    gate: torch.Tensor,                   # (B, S, W) compute dtype
    h0: Optional[torch.Tensor] = None,    # (B, W) fp32
    *,
    return_state: bool = False,
):
    """An RG-LRU layer's gates, recurrence and output product: ``r =
    sigmoid(r_pre + b_r)``, ``i = sigmoid(i_pre + b_i)``, ``a =
    exp(-8 softplus(lam) r)``, ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t
    xr_t`` in fp32, ``y = h.to(dtype) * gate``. Returns ``y`` (B, S, W),
    or ``(y, h_S)`` with the fp32 state after the last step."""
    xf = xr.float()
    r = torch.sigmoid(r_pre + b_r)
    i = torch.sigmoid(i_pre + b_i)
    log_a = -RGLRU_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h = lru_scan_ref(a, beta * i * xf, h0)
    y = h.to(xr.dtype) * gate
    if not return_state:
        return y
    if h.shape[1]:
        return y, h[:, -1]
    return y, (h0 if h0 is not None else
               xr.new_zeros((xr.shape[0], xr.shape[2]), dtype=torch.float32))


def reassemble_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Block-gather: src (NB, ...), idx (NBo,) -> out (NBo, ...)."""
    return src.index_select(0, idx.to(device=src.device, dtype=torch.int64))


def window_batch_ref(
    linear: torch.Tensor,      # (L,) file-order tokens
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_limit: int | None = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused batch-major + shift: row ``b`` covers flat positions
    ``window_tok_off + b*(S+1) + j``; labels are shifted by one; positions at
    or past ``valid_limit`` (or past the buffer) read ``pad_id``."""
    B, S = global_batch, seq_len
    S1 = S + 1
    w0 = window_tok_off
    full_limit = w0 + B * S1
    if valid_limit is None:
        valid_limit = full_limit
    L = linear.shape[0]
    if L < full_limit:
        linear = torch.cat([linear, linear.new_full((full_limit - L,), pad_id)])
    seqs = linear[w0:w0 + B * S1].reshape(B, S1)
    inputs = seqs[:, :S]
    labels = seqs[:, 1:]
    if valid_limit < full_limit:
        pad = torch.tensor(pad_id, dtype=linear.dtype, device=linear.device)
        pos = (w0 + torch.arange(B, device=linear.device)[:, None] * S1
               + torch.arange(S, device=linear.device)[None, :])
        inputs = torch.where(pos < valid_limit, inputs, pad)
        labels = torch.where(pos + 1 < valid_limit, labels, pad)
    return inputs.contiguous(), labels.contiguous()


def window_chunks_ref(chunks: Sequence[torch.Tensor], **kw
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window_batch_ref`` over the concatenation of file-order chunks."""
    chunks = list(chunks)
    linear = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
    return window_batch_ref(linear, **kw)


def tokens_gather_ref(
    staged: torch.Tensor, row_idx: torch.Tensor, *, pad_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token gather (``row_idx < 0`` pads; other indices clip to the buffer)."""
    S = row_idx.shape[1] - 1
    safe = row_idx.clamp(0, staged.shape[0] - 1).to(torch.int64)
    rows = staged[safe]
    pad = torch.tensor(pad_id, dtype=staged.dtype, device=staged.device)
    inputs = torch.where(row_idx[:, :S] >= 0, rows[:, :S], pad)
    labels = torch.where(row_idx[:, 1:S + 1] >= 0, rows[:, 1:S + 1], pad)
    return inputs, labels
