"""Plain PyTorch versions of the port's kernels: the ground truth the CUDA
kernels are held to (bit-exact for the reassembly gathers, within the
stated tolerance for attention and the two scans), and the path CPU
tensors take."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the scans' accumulation type: fp32, or ``t``'s own type
    where it is wider (float64, in which the gradient checks run)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def attention_ref(
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Dense softmax attention, GQA by head-group folding, fp32 throughout;
    the output is cast to q's dtype. Causal positions are end-aligned
    (query i sits at i + Sk - Sq); the window applies to causal masks only,
    and a row with every key masked softmaxes over the -2e38 fill (uniform
    weights), as in the reference oracle. ``softcap > 0`` caps the scaled
    scores to ``softcap * tanh(s / softcap)`` before the mask, as the
    reference's ``_sdpa`` does."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * (hd ** -0.5)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
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


def _train_mask(Sq: int, Sk: int, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: the keys a row keeps under the end-aligned causal
    mask and, with ``window`` > 0, the sliding window."""
    i = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    j = torch.arange(Sk, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= (i - j) < window
    return m


def attention_train_ref(
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward written plainly: causal attention in fp32 (the
    output cast to q's dtype) and each row's log-sum-exp of its kept scaled
    scores, ``(B, H, Sq)`` fp32. A row that keeps no key gives 0 and an lse
    of +inf, as the kernel does."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    s = torch.einsum("bkgqd,bksd->bkgqs", q.reshape(B, K, G, Sq, hd).float(),
                     k.float()) * (hd ** -0.5)
    m = _train_mask(Sq, Sk, window, q.device)
    s = s.masked_fill(~m, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    live = m.any(dim=-1)
    lse = torch.where(live, lse, torch.full_like(lse, float("inf")))
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return (o.reshape(B, H, Sq, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def row_relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of a row (the last dim) over the row's largest
    magnitude, over all rows: how an attention output is held, each row
    being an average of values whose rounding scales with the row. A row
    of zeros (no key kept) counts its error over 2^-14."""
    g, w = got.float(), want.float()
    if not w.numel():
        return 0.0
    den = w.abs().amax(-1).clamp_min(2.0 ** -14)
    return ((g - w).abs().amax(-1) / den).max().item()


def attention_train_bwd_ref(
    dout: torch.Tensor,       # (B, H, Sq, hd)
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    out: torch.Tensor,        # (B, H, Sq, hd)
    lse: torch.Tensor,        # (B, H, Sq) fp32
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of :func:`attention_train_ref` from its output and
    log-sum-exp, as the backward kernels form them, in fp32: P = exp(s -
    lse) on the kept pairs, D = rowsum(dO * O), dS = P (dO V^T - D); dV =
    P^T dO, dK = scale dS^T Q, dQ = scale dS K, the G query heads of a kv
    head summed. Each cast to its input's dtype."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qf = q.reshape(B, K, G, Sq, hd).float()
    do = dout.reshape(B, K, G, Sq, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    m = _train_mask(Sq, Sk, window, q.device)
    p = torch.where(m, torch.exp(s - lse.reshape(B, K, G, Sq, 1)),
                    torch.zeros_like(s))
    d = (do * out.reshape(B, K, G, Sq, hd).float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", do, vf) - d)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    return (dq.reshape(B, H, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_split_ref(
    q: torch.Tensor,          # (B, H, Sq, hd)
    k: torch.Tensor,          # (B, K, Sk, hd)
    v: torch.Tensor,          # (B, K, Sk, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The split-key decode path written plainly: the key axis cut by
    ``flash_attention.split_plan``, the splits that ``split_range``
    launches each reduced to fp32 partials (max ``m``, denominator ``l``,
    unnormalised accumulator), then merged in split order with weights
    ``exp(m - max)``, a split whose max is the -2e38 fill weighing 0. A row
    with no kept key gives 0 (the denominator is clamped to 1e-30), as in
    the kernel and the Pallas kernel; ``attention_ref`` averages over the
    fill there instead. ``softcap`` caps the scaled scores before the mask,
    as in ``attention_ref``."""
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
        if softcap > 0.0:
            sc = torch.tanh(sc / softcap) * softcap
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
    dt = _acc(F.softplus(dt_pre + dt_bias.to(dtype)))       # (B, S, D)
    A = -torch.exp(_acc(A_log))                             # (D, N)
    Abar = torch.exp(dt[..., None] * A)
    Bx = dt[..., None] * _acc(Bc[..., None, :]) * _acc(xin[..., None])
    y, h = ssm_scan_ref(Abar, Bx, _acc(Cc), h0, return_state=True)
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
    xf = _acc(xr)
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
               xr.new_zeros((xr.shape[0], xr.shape[2]), dtype=xf.dtype))


def ssm_scan_bwd_ref(
    gy: torch.Tensor,                     # (B, S, D) fp32
    Abar: torch.Tensor,                   # (B, S, D, N) fp32
    Bx: torch.Tensor,                     # (B, S, D, N) fp32
    C: torch.Tensor,                      # (B, S, N) fp32
    h0: Optional[torch.Tensor] = None,    # (B, D, N) fp32
):
    """The gradient of ``ssm_scan_ref``'s ``y`` from ``dL/dy``: ``(dAbar,
    dBx, dC, dh0)``, ``dh0`` None without ``h0``. The states are
    recomputed, then the reverse recurrence runs a step at a time:
    ``g_t = gy_t C_t + Abar_{t+1} g_{t+1}``, ``dBx_t = g_t``, ``dAbar_t =
    g_t h_{t-1}``, ``dC_t = sum_d gy_t h_t``, ``dh0 = Abar_0 g_0``."""
    B, S, D, N = Abar.shape
    h = Abar.new_zeros((B, D, N)) if h0 is None else h0
    hs = [h]                                # hs[t] = h_{t-1}
    for t in range(S):
        h = Abar[:, t] * h + Bx[:, t]
        hs.append(h)
    dA, dBx, dC = (torch.empty_like(Abar), torch.empty_like(Bx),
                   torch.empty_like(C))
    g = Abar.new_zeros((B, D, N))
    for t in reversed(range(S)):
        g = gy[:, t, :, None] * C[:, t, None, :] + (
            Abar[:, t + 1] * g if t + 1 < S else 0.0)
        dBx[:, t] = g
        dA[:, t] = g * hs[t]
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], gy[:, t])
    dh0 = None
    if h0 is not None:
        dh0 = Abar[:, 0] * g if S else torch.zeros_like(h0)
    return dA, dBx, dC, dh0


def mamba_scan_fused_bwd_ref(
    gy: torch.Tensor,                     # (B, S, D) compute dtype
    xin: torch.Tensor,
    dt_pre: torch.Tensor,
    dt_bias: torch.Tensor,
    A_log: torch.Tensor,
    proj: torch.Tensor,
    Dskip: torch.Tensor,
    z: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """The gradient of ``mamba_scan_fused_ref``'s ``y`` from ``dL/dy``:
    ``(dxin, ddt_pre, ddt_bias, dA_log, dproj, dDskip, dz, dh0)`` in the
    inputs' dtypes, ``dh0`` None without ``h0``. Each op of the forward is
    differentiated by hand in the dtype the forward computes it in; the
    scan's part is ``ssm_scan_bwd_ref``."""
    dtype = xin.dtype
    n = A_log.shape[1]
    r = proj.shape[-1] - 2 * n
    Bc, Cc = _acc(proj[..., r:r + n]), _acc(proj[..., r + n:])
    s = dt_pre + dt_bias.to(dtype)
    dt = _acc(F.softplus(s))
    A = -torch.exp(_acc(A_log))
    Abar = torch.exp(dt[..., None] * A)
    xf = _acc(xin)
    Bx = dt[..., None] * Bc[..., None, :] * xf[..., None]
    y32 = ssm_scan_ref(Abar, Bx, Cc, h0)
    # y = (y32.to(dtype) + Dskip.to(dtype) * xin) * silu(z)
    sz = F.silu(z)
    ypre = y32.to(dtype) + Dskip.to(dtype) * xin
    dypre = gy * sz
    sig = torch.sigmoid(z)
    dz = gy * ypre * (sig * (1 + z * (1 - sig)))
    dDskip = _acc((dypre * xin).sum((0, 1)))
    dA_bar, dBx, dCc, dh0 = ssm_scan_bwd_ref(_acc(dypre), Abar, Bx, Cc, h0)
    # Bx = dt Bc x, Abar = exp(dt A)
    dlin = dA_bar * Abar
    ddt = (dlin * A).sum(-1) + (dBx * Bc[..., None, :] * xf[..., None]).sum(-1)
    dx = (dBx * dt[..., None] * Bc[..., None, :]).sum(-1)
    dBc = (dBx * dt[..., None] * xf[..., None]).sum(-2)
    dA = (dlin * dt[..., None]).sum((0, 1))
    dxin = dypre * Dskip.to(dtype) + dx.to(dtype)
    ds = (ddt.to(dtype) * torch.where(s > 20, torch.ones_like(s),
                                      torch.sigmoid(s)))
    dproj = torch.zeros_like(proj)
    dproj[..., r:r + n] = dBc.to(dtype)
    dproj[..., r + n:] = dCc.to(dtype)
    return (dxin, ds, _acc(ds.sum((0, 1))), dA * A, dproj, dDskip, dz, dh0)


def rglru_scan_gated_bwd_ref(
    gy: torch.Tensor,                     # (B, S, W) compute dtype
    r_pre: torch.Tensor,
    i_pre: torch.Tensor,
    b_r: torch.Tensor,
    b_i: torch.Tensor,
    lam: torch.Tensor,
    xr: torch.Tensor,
    gate: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """The gradient of ``rglru_scan_gated_ref``'s ``y`` from ``dL/dy``:
    ``(dr_pre, di_pre, db_r, db_i, dlam, dxr, dgate, dh0)`` in the inputs'
    dtypes, ``dh0`` None without ``h0``. The gates and states are
    recomputed, then the reverse recurrence runs a step at a time, ``g_t =
    gy_t gate_t + a_{t+1} g_{t+1}``; each gate is differentiated by hand."""
    B, S, W = xr.shape
    xf = _acc(xr)
    r = torch.sigmoid(r_pre + b_r)
    i = torch.sigmoid(i_pre + b_i)
    sp = F.softplus(lam)
    log_a = -RGLRU_C * sp * r
    a = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    inner = 1.0 - e2
    beta = torch.sqrt(torch.clamp(inner, min=1e-12))
    h = lru_scan_ref(a, beta * i * xf, h0)
    prev = torch.cat([(h0 if h0 is not None else h.new_zeros((B, W)))[:, None],
                      h[:, :-1]], dim=1)             # h_{t-1}
    dgate = gy * h.to(xr.dtype)
    gh = _acc(gy * gate)
    g = torch.empty_like(h)
    acc = h.new_zeros((B, W))
    for t in reversed(range(S)):
        acc = gh[:, t] + (a[:, t + 1] * acc if t + 1 < S else 0.0)
        g[:, t] = acc
    gx = g * xf
    dbeta = gx * i
    dlog = g * prev * a + torch.where(
        inner >= 1e-12, 2.0 * (-(dbeta / (2.0 * beta)) * e2),
        torch.zeros_like(e2))
    dr = dlog * (-RGLRU_C * sp)
    drp = dr * (1 - r) * r
    dip = gx * beta * (1 - i) * i
    dc = (dlog * r).sum((0, 1))
    dlam = dc * -RGLRU_C * torch.where(lam > 20, torch.ones_like(lam),
                                       torch.sigmoid(lam))
    dxr = (g * (beta * i)).to(xr.dtype)
    dh0 = None
    if h0 is not None:
        dh0 = a[:, 0] * acc if S else torch.zeros_like(h0)
    return (drp, dip, drp.sum((0, 1)), dip.sum((0, 1)), dlam, dxr, dgate,
            dh0)


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
