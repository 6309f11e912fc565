"""Serving steps: the decode call and the greedy generation loop.

The reference jits its decode step; the port runs eagerly (a CUDA graph
over the decode call is later work, ROADMAP.md Queue D), so
``make_decode_step`` only fixes the model and turns autograd off.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.model_zoo import Model


def make_decode_step(model: Model):
    @torch.no_grad()
    def decode(params, state, batch):
        return model.decode(params, state, batch)

    return decode


def greedy_generate(
    model: Model,
    params: Any,
    prompt: torch.Tensor,             # (B, S) int32, on the params' device
    max_new_tokens: int,
    *,
    seq_budget: Optional[int] = None,
    eos_id: Optional[int] = None,
    frames: Optional[Any] = None,
) -> torch.Tensor:
    """Static-batch greedy decoding (uniform prompt lengths; shorter prompts
    are left-padded by the caller and the pads are decoded like tokens).

    Prefill primes the decode state by replaying the prompt through
    ``decode_step`` token by token (correct for every family incl. SSM /
    RG-LRU state carrying), then greedily samples ``max_new_tokens``.
    """
    B, S = prompt.shape
    budget = seq_budget or (S + max_new_tokens)
    with torch.no_grad():     # an enc-dec model's encoder runs the kernel
        state = model.init_decode_state(params, B, budget, frames=frames)
    decode = make_decode_step(model)

    logits = None
    for t in range(S):
        logits, state = decode(params, state, {"tokens": prompt[:, t: t + 1]})
    outs = []
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    done = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
    for _ in range(max_new_tokens):
        outs.append(tok)
        if eos_id is not None:
            done = done | (tok[:, 0] == eos_id)
            if bool(done.all()):
                break
        logits, state = decode(params, state, {"tokens": tok})
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    return torch.cat(outs, dim=1)
