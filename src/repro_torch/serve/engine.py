"""Slot-based decode engines for the continuous batcher.

A decode engine owns ``slots`` independent generation lanes:

  * ``admit(slot, prompt)``  prime a free slot from a prompt token sequence
    (the "prefill"). The prompt is consumed *during* the call — engines
    never retain a reference, so callers may hand in a borrowed arena view
    and close its session the moment ``admit`` returns.
  * ``step()``               generate one token on every occupied slot;
    returns ``{slot: token}``.
  * ``evict(slot)``          free the slot (EOS / max-tokens — decided by
    the batcher, engines are policy-free).

Slots are fully independent: a slot's token stream depends only on its own
prompt, never on which other slots are occupied or when neighbours were
admitted/evicted. That independence is what makes continuous batching
bit-identical to a sequential oracle (``decode_one`` below is the shared
completion rule both use).

Two implementations:

  * :class:`ModeledEngine` — a deterministic hash-fold "LM" with an
    explicit wall-clock cost model (``step_base_s + step_slot_s * occupied``
    per step). This is the churn-benchmark engine: it reproduces the
    economics of batched decode (per-step fixed cost amortized over
    occupied slots; static batches pay for stragglers) while running hot in
    CI, and its outputs are exactly reproducible for oracle comparison.
  * :class:`ModelEngine` — the real thing: wraps a ``model_zoo`` model with
    one B=1 decode state per slot (prefill = replaying the prompt through
    the decode step, matching ``serve_step.greedy_generate`` semantics
    token for token).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.serve_step import make_decode_step

_FOLD_MOD = (1 << 61) - 1
_FOLD_MUL = 1000003


class ModeledEngine:
    """Deterministic modeled decode engine (see module docstring).

    Token function: a slot's state is a running hash fold of everything it
    has seen (prompt then generated tokens); the next token is
    ``state % vocab``. Same prompt -> same stream, independent of slot
    index, admission time, or co-residents.
    """

    def __init__(
        self,
        slots: int,
        *,
        vocab: int = 256,
        step_base_s: float = 0.0,
        step_slot_s: float = 0.0,
        prefill_token_s: float = 0.0,
    ):
        if slots < 1:
            raise ValueError("need at least one decode slot")
        self.slots = slots
        self.vocab = vocab
        self.step_base_s = step_base_s
        self.step_slot_s = step_slot_s
        self.prefill_token_s = prefill_token_s
        self._h: List[Optional[int]] = [None] * slots
        self._pending: List[Optional[int]] = [None] * slots

    def occupied(self) -> List[int]:
        return [i for i, h in enumerate(self._h) if h is not None]

    def free_slots(self) -> List[int]:
        return [i for i, h in enumerate(self._h) if h is None]

    def admit(self, slot: int, prompt: Sequence[int]) -> None:
        if self._h[slot] is not None:
            raise RuntimeError(f"slot {slot} already occupied")
        h = 1
        for t in prompt:
            h = (h * _FOLD_MUL + int(t) + 1) % _FOLD_MOD
        if self.prefill_token_s:
            time.sleep(self.prefill_token_s * len(prompt))
        self._h[slot] = h
        self._pending[slot] = h % self.vocab

    def step(self) -> Dict[int, int]:
        occ = self.occupied()
        if not occ:
            return {}
        cost = self.step_base_s + self.step_slot_s * len(occ)
        if cost:
            time.sleep(cost)
        out: Dict[int, int] = {}
        for i in occ:
            tok = self._pending[i]
            out[i] = tok
            h = (self._h[i] * _FOLD_MUL + tok + 1) % _FOLD_MOD
            self._h[i] = h
            self._pending[i] = h % self.vocab
        return out

    def evict(self, slot: int) -> None:
        self._h[slot] = None
        self._pending[slot] = None


class ModelEngine:
    """Per-slot B=1 decode over a real ``model_zoo`` model.

    Greedy semantics match ``serve_step.greedy_generate`` exactly: prefill
    replays the prompt through the decode step token by token (correct for
    state-carrying families — SSM / RG-LRU), the first generated token is
    the argmax over the prompt's final logits, and each ``step`` feeds the
    previous token back through decode. A continuous run is therefore
    bit-identical to calling ``greedy_generate`` on each request alone
    (on the card too: every kernel of the step sums in a fixed order).
    """

    def __init__(
        self,
        model: Any,
        params: Any,
        slots: int,
        *,
        seq_budget: int = 256,
        frames: Optional[Any] = None,
    ):
        if slots < 1:
            raise ValueError("need at least one decode slot")
        self.model = model
        self.params = params
        self.slots = slots
        self.seq_budget = seq_budget
        self.frames = frames
        self._device = model.device(params)
        self._decode = make_decode_step(model)
        self._state: List[Optional[Any]] = [None] * slots
        self._pending: List[Optional[int]] = [None] * slots

    def occupied(self) -> List[int]:
        return [i for i, s in enumerate(self._state) if s is not None]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._state) if s is None]

    def _tok_batch(self, tok: int):
        return {"tokens": torch.tensor([[int(tok)]], dtype=torch.int32,
                                       device=self._device)}

    def admit(self, slot: int, prompt: Sequence[int]) -> None:
        if self._state[slot] is not None:
            raise RuntimeError(f"slot {slot} already occupied")
        # One upload of the prompt (the borrowed view is consumed here).
        toks = torch.from_numpy(np.asarray(prompt).astype(np.int32)).to(
            self._device)
        if toks.numel() == 0:
            raise ValueError("empty prompt")
        state = self.model.init_decode_state(
            self.params, 1, self.seq_budget, frames=self.frames)
        logits = None
        for t in range(toks.numel()):
            logits, state = self._decode(self.params, state,
                                         {"tokens": toks[None, t: t + 1]})
        self._state[slot] = state
        self._pending[slot] = int(logits[:, -1].argmax(dim=-1)[0])

    def step(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for i in self.occupied():
            tok = self._pending[i]
            out[i] = tok
            logits, state = self._decode(
                self.params, self._state[i], self._tok_batch(tok))
            self._state[i] = state
            self._pending[i] = int(logits[:, -1].argmax(dim=-1)[0])
        return out

    def evict(self, slot: int) -> None:
        self._state[slot] = None
        self._pending[slot] = None


def decode_one(
    engine: Any,
    slot: int,
    prompt: Sequence[int],
    max_new_tokens: int,
    eos_id: Optional[int] = None,
) -> List[int]:
    """The completion rule, shared by batchers and the oracle: generate
    until ``max_new_tokens`` tokens or EOS (EOS token included)."""
    engine.admit(slot, prompt)
    out: List[int] = []
    while True:
        tok = engine.step()[slot]
        out.append(tok)
        if len(out) >= max_new_tokens or (eos_id is not None
                                          and tok == eos_id):
            break
    engine.evict(slot)
    return out


def sequential_oracle(
    engine: Any,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: Sequence[int],
    eos_id: Optional[int] = None,
) -> List[List[int]]:
    """Decode each request *alone*, in order, on slot 0 of ``engine`` —
    the ground truth any batched schedule must be bit-identical to."""
    return [
        decode_one(engine, 0, p, int(m), eos_id)
        for p, m in zip(prompts, max_new_tokens)
    ]
