"""Plain PyTorch reference of the benchmark's training step, in fp32.

The forward pass, the loss, the gradients (autograd) and the AdamW step,
written from the published equations on the parameter tree's layout
(``perfbench/weights`` makes the tree from the seed). Each layer is a
pre-norm residual mixer, then, unless its FFN is ``none``, a pre-norm
residual FFN; ``m["schedule"]`` gives each layer's ``{"mixer", "ffn"}``,
looked up in ``MIXERS`` and ``FFNS`` (their parameters' shapes in
``MIXER_SHAPES`` and ``FFN_SHAPES``), in any mix:

* mixer ``attn``: grouped-query attention with rotary embeddings
  (rotate-half, over the whole head) and a causal softmax (Phi-4-mini);
* mixer ``mamba``: the Mamba-1 mixer (in-projection, causal depthwise
  conv + SiLU, x/dt projections, softplus, the selective scan
  ``h_t = exp(dt A) h_{t-1} + dt B x``, readout with C, skip D, SiLU gate,
  out-projection) (Falcon-Mamba);
* FFN ``dense``: a SwiGLU MLP; ``none``: no FFN and no second norm;

each norm an RMSNorm with scale ``1 + w``; then a final RMSNorm, the tied
or untied head and the mean cross-entropy.
Matmuls run in fp32 with TF32 off. Each layer is recomputed in the
backward pass (``torch.utils.checkpoint``), so that a deep stack's fp32
activations fit beside its parameters and AdamW's state: one layer's are
held at a time, and the arithmetic is the same. ``precision="fp8"`` rounds both
operands of every matmul, forward and backward, to float8 e4m3 with a
per-tensor scale: the control, one step below the bf16 the configurations
compute in. Nothing of the program is imported. A configuration's own
reference module may reuse these pieces and ``train``'s loop with a loss
of its own (``train(..., loss_fn=...)``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, in fp32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast batch dims reduce back to the operand's shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        for i, (n, m) in enumerate(zip(ga.shape, qa.shape)):
            if m == 1 and n != 1:
                ga = ga.sum(i, keepdim=True)
        for i, (n, m) in enumerate(zip(gb.shape, qb.shape)):
            if m == 1 and n != 1:
                gb = gb.sum(i, keepdim=True)
        return ga, gb


def matmul_for(precision: str) -> Callable:
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


# -- the selective scan: a linear recurrence by recursive doubling -----------
def _doubling(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along dim 1 from ``h_{-1} = 0``."""
    a, b = a.clone(), b.clone()
    S, k = a.shape[1], 1
    while k < S:
        b_new = b[:, k:] + a[:, k:] * b[:, :-k]
        a_new = a[:, k:] * a[:, :-k]
        b[:, k:] = b_new
        a[:, k:] = a_new
        del b_new, a_new
        k *= 2
    return b


class LinearScan(torch.autograd.Function):
    """The recurrence with its gradient: ``dh_t = g_t + a_{t+1} dh_{t+1}``
    by the same doubling run backwards; ``da_t = dh_t h_{t-1}``,
    ``db_t = dh_t``."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        dh = _doubling(a_next.flip(1), g.flip(1)).flip(1)
        del a_next
        da = torch.zeros_like(a)
        da[:, 1:] = dh[:, 1:] * h[:, :-1]
        return da, dh


# -- layers -------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + scale)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of x (B, S, heads, hd) at 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(p: Dict, h: torch.Tensor, m: Dict, mm: Callable) -> torch.Tensor:
    B, S, d = h.shape
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    G = H // K
    x2 = h.reshape(B * S, d)
    q = mm(x2, p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
    k = mm(x2, p["wk"].reshape(d, K * hd)).view(B, S, K, hd)
    v = mm(x2, p["wv"].reshape(d, K * hd)).view(B, S, K, hd)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    qg = q.view(B, S, K, G, hd).permute(0, 2, 3, 1, 4)       # B K G S hd
    kt = k.permute(0, 2, 3, 1).unsqueeze(2)                  # B K 1 hd S
    scores = mm(qg, kt) * hd ** -0.5                          # B K G S S
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    vv = v.permute(0, 2, 1, 3).unsqueeze(2)                   # B K 1 S hd
    out = mm(probs, vv)                                       # B K G S hd
    out = out.permute(0, 3, 1, 2, 4).reshape(B * S, H * hd)
    return mm(out, p["wo"].reshape(H * hd, d)).view(B, S, d)


def swiglu(p: Dict, h: torch.Tensor, m: Dict, mm: Callable) -> torch.Tensor:
    B, S, d = h.shape
    x2 = h.reshape(B * S, d)
    a = F.silu(mm(x2, p["gate"])) * mm(x2, p["up"])
    return mm(a, p["down"]).view(B, S, d)


def mamba(p: Dict, h: torch.Tensor, m: Dict, mm: Callable) -> torch.Tensor:
    B, S, d = h.shape
    di, n, r = m["d_inner"], m["ssm_state"], m["dt_rank"]
    cw = p["conv_w"].shape[0]
    xz = mm(h.reshape(B * S, d), p["in_proj"]).view(B, S, 2 * di)
    xin, z = xz[..., :di], xz[..., di:]
    xp = F.pad(xin, (0, 0, cw - 1, 0))
    conv = p["conv_b"] + sum(p["conv_w"][j] * xp[:, j:j + S]
                             for j in range(cw))
    xin = F.silu(conv)
    proj = mm(xin.reshape(B * S, di), p["x_proj"]).view(B, S, r + 2 * n)
    dt_in, Bc, Cc = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(mm(dt_in.reshape(B * S, r), p["dt_proj"]).view(B, S, di)
                    + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                # di n
    Abar = torch.exp(dt[..., None] * A)                       # B S di n
    Bx = (dt * xin)[..., None] * Bc[:, :, None, :]
    hs = LinearScan.apply(Abar, Bx)
    del Abar, Bx
    y = (hs * Cc[:, :, None, :]).sum(-1) + p["D"] * xin
    y = y * F.silu(z)
    return mm(y.reshape(B * S, di), p["out_proj"]).view(B, S, d)


def _kind(table: Dict, part: str, kind: Dict[str, str]):
    if kind[part] not in table:
        raise ValueError(f"unknown {part} {kind[part]!r}")
    return table[kind[part]]


MIXERS = {"attn": attention, "mamba": mamba}
FFNS: Dict[str, Optional[Callable]] = {"dense": swiglu, "none": None}


def layer(lp: Dict, kind: Dict[str, str], m: Dict, x: torch.Tensor,
          mm: Callable) -> torch.Tensor:
    eps = m["norm_eps"]
    x = x + _kind(MIXERS, "mixer", kind)(
        lp["mixer"], rmsnorm(x, lp["norm1"]["scale"], eps), m, mm)
    ffn = _kind(FFNS, "ffn", kind)
    if ffn is not None:
        x = x + ffn(lp["ffn"], rmsnorm(x, lp["norm2"]["scale"], eps), m, mm)
    return x


def loss_fn(params: Dict, m: Dict, tokens: torch.Tensor, labels: torch.Tensor,
            mm: Callable) -> torch.Tensor:
    eps = m["norm_eps"]
    x = params["embed"]["table"][tokens]
    for lp, kind in zip(params["layers"], m["schedule"], strict=True):
        x = checkpoint(layer, lp, kind, m, x, mm, use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], eps)
    B, S, d = x.shape
    head = (params["embed"]["table"].t() if m["tie_embeddings"]
            else params["lm_head"]["w"])
    logits = mm(x.reshape(B * S, d), head)
    gold = logits.gather(1, labels.reshape(-1, 1))[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def attention_shapes(m: Dict) -> Dict[str, tuple]:
    d, H, K, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return {"wq": (d, H, hd), "wk": (d, K, hd), "wv": (d, K, hd),
            "wo": (H, hd, d)}


def mamba_shapes(m: Dict) -> Dict[str, tuple]:
    d, di, n, r, cw = (m["d_model"], m["d_inner"], m["ssm_state"],
                       m["dt_rank"], m["conv_width"])
    return {"in_proj": (d, 2 * di), "conv_w": (cw, di), "conv_b": (di,),
            "x_proj": (di, r + 2 * n), "dt_proj": (r, di), "dt_bias": (di,),
            "A_log": (di, n), "D": (di,), "out_proj": (di, d)}


def swiglu_shapes(m: Dict) -> Dict[str, tuple]:
    d, ff = m["d_model"], m["d_ff"]
    return {"gate": (d, ff), "up": (d, ff), "down": (ff, d)}


MIXER_SHAPES = {"attn": attention_shapes, "mamba": mamba_shapes}
FFN_SHAPES: Dict[str, Optional[Callable]] = {"dense": swiglu_shapes,
                                             "none": None}


def param_shapes(m: Dict) -> Dict[str, tuple]:
    """``{leaf path: shape}`` of the parameter tree the layers above read,
    each layer's from its kinds in ``m["schedule"]``."""
    d, V = m["d_model"], m["vocab_size"]
    out = {"embed.table": (V, d), "final_norm.scale": (d,)}
    for i, kind in enumerate(m["schedule"]):
        p = f"layers.{i}."
        out[p + "norm1.scale"] = (d,)
        for k, shape in _kind(MIXER_SHAPES, "mixer", kind)(m).items():
            out[p + "mixer." + k] = shape
        ffn = _kind(FFN_SHAPES, "ffn", kind)
        if ffn is not None:
            out[p + "norm2.scale"] = (d,)
            for k, shape in ffn(m).items():
                out[p + "ffn." + k] = shape
    if not m["tie_embeddings"]:
        out["lm_head.w"] = (d, V)
    return out


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``min_lr_ratio`` of it at ``decay_steps``."""
    s, w = float(step), opt["warmup_steps"]
    if s < w:
        return opt["peak_lr"] * s / max(w, 1)
    t = min(max((s - w) / max(opt["decay_steps"] - w, 1), 0.0), 1.0)
    lo = opt.get("min_lr_ratio", 0.1)
    return opt["peak_lr"] * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * t)))


def train(params: Dict, paths: List[str], m: Dict, opt: Dict, batches,
          microbatches: int, precision: str = "fp32",
          rows: Optional[Callable] = None,
          loss_fn: Callable = loss_fn) -> Dict:
    """Run ``len(batches)`` AdamW steps from ``params`` (a tree whose
    leaves, in ``paths`` order, are updated in place). ``batches`` yields
    (tokens, labels) on the params' device; ``rows`` maps a microbatch's
    (tokens, labels) to the rows that enter the loss (a planted fault);
    ``loss_fn(params, m, tokens, labels, mm)`` is this module's unless a
    configuration's reference gives its own.
    Returns each step's loss, the first step's clipped gradient norm by
    leaf path and each leaf's change over the run by path."""
    mm = matmul_for(precision)
    leaves = _leaves(params)
    start = [p.detach().clone() for p in leaves]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    out = {"loss": [], "grad_norm": None}
    with exact_fp32():
        for step, (tok, lab) in enumerate(batches, start=1):
            loss_sum = 0.0
            for p in leaves:
                p.requires_grad_(True)
            # each microbatch's gradient is summed into the leaves' .grad
            for t, l in zip(tok.chunk(microbatches), lab.chunk(microbatches)):
                if rows is not None:
                    t, l = rows(t, l)
                loss = loss_fn(params, m, t, l, mm)
                loss.backward()
                loss_sum += float(loss.detach())
                del loss
            g = [p.grad for p in leaves]
            for p in leaves:
                p.grad = None
                p.requires_grad_(False)
            with torch.no_grad():
                for x in g:
                    x.div_(microbatches)
                norm = torch.sqrt(sum(x.square().sum() for x in g))
                clip = min(1.0, opt["grad_clip"] / max(float(norm), 1e-9)) \
                    if opt["grad_clip"] > 0 else 1.0
                for x in g:
                    x.mul_(clip)
                if step == 1:
                    out["grad_norm"] = {k: float(x.norm())
                                        for k, x in zip(paths, g)}
                lr = lr_at(opt, step)
                b1, b2 = opt["b1"], opt["b2"]
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for p, x, m1, m2 in zip(leaves, g, mu, nu):
                    m1.mul_(b1).add_(x, alpha=1 - b1)
                    m2.mul_(b2).add_(x.square(), alpha=1 - b2)
                    upd = (m1 / bc1) / ((m2 / bc2).sqrt() + opt["eps"])
                    p.sub_(lr * (upd + opt["weight_decay"] * p))
                del g
            out["loss"].append(loss_sum / microbatches)
    out["change"] = {k: float((p - s).norm())
                     for k, p, s in zip(paths, leaves, start)}
    return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
