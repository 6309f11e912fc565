"""Model facade: one interface over the decoder-only stack (dense
attention blocks, attention-free Mamba-1 blocks and Griffin's RG-LRU and
local-attention blocks so far)."""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.is_encdec:
            raise NotImplementedError(
                "encoder-decoder models come with the whisper slice "
                "(ROADMAP.md, Queue A)")
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init(self, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
        """Random params from ``seed`` (a ``torch.Generator`` on ``device``).
        The numbers differ from the reference's ``jax.random`` init; tests
        that compare the two convert the reference's params instead
        (``models/convert.py``)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return transformer.init_model(gen, self.cfg, dev)

    # -- steps ------------------------------------------------------------------
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return transformer.loss_fn(params, self.cfg, batch)

    def prefill_logits(self, params, batch) -> torch.Tensor:
        return transformer.forward_logits(params, self.cfg, batch)

    def decode(self, params, state, batch):
        return transformer.decode_step(params, self.cfg, state, batch)

    def init_decode_state(self, params, batch_size: int, seq_budget: int,
                          frames=None):
        """The empty decode state on the device of ``params``: one KV cache
        per attention layer (a ring of the window's size for a local
        layer), one zero ``MambaState`` or ``RGLRUState`` (recurrent state
        and conv tail) per Mamba or RG-LRU layer."""
        if frames is not None:
            raise NotImplementedError(
                "encoder frames: encoder-decoder decode comes with the "
                "whisper slice (ROADMAP.md, Queue A item 9)")
        return transformer.init_decode_state(self.cfg, batch_size, seq_budget,
                                             self.device(params))

    @staticmethod
    def device(params) -> torch.device:
        """The device the params (and so the model's steps) live on."""
        return params["embed"]["table"].device


@functools.lru_cache(maxsize=None)
def _cached_model(name: str) -> Model:
    from repro_torch.configs.registry import get_config

    return Model(get_config(name))


def build_model(cfg_or_name) -> Model:
    if isinstance(cfg_or_name, str):
        return _cached_model(cfg_or_name)
    return Model(cfg_or_name)
