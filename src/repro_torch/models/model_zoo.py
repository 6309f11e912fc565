"""Model facade: one interface over the decoder-only stack (global and
local attention blocks with dense or Mixture-of-Experts FFNs,
attention-free Mamba-1 blocks and Griffin's RG-LRU blocks; token or
patch-embedding input) and the encoder-decoder stack (whisper), picked by
``cfg.is_encdec`` as in the reference."""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._m = encdec if cfg.is_encdec else transformer

    # -- params ---------------------------------------------------------------
    def init(self, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
        """Random params from ``seed`` (a ``torch.Generator`` on ``device``).
        The numbers differ from the reference's ``jax.random`` init; tests
        that compare the two convert the reference's params instead
        (``models/convert.py``)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return self._m.init_model(gen, self.cfg, dev)

    # -- steps ------------------------------------------------------------------
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._m.loss_fn(params, self.cfg, batch)

    def prefill_logits(self, params, batch) -> torch.Tensor:
        return self._m.forward_logits(params, self.cfg, batch)

    def decode(self, params, state, batch):
        return self._m.decode_step(params, self.cfg, state, batch)

    def init_decode_state(self, params, batch_size: int, seq_budget: int,
                          frames=None):
        """The decode state on the device of ``params``. Decoder-only: one
        empty KV cache per attention layer (a ring of the window's size for
        a local layer), one zero ``MambaState`` or ``RGLRUState``
        (recurrent state and conv tail) per Mamba or RG-LRU layer.
        Encoder-decoder: ``frames`` (``batch_size``, S_enc, d) run through
        the encoder once (:meth:`place_frames` moves them first), then
        ``encdec.init_decode_state``."""
        if not self.cfg.is_encdec:
            if frames is not None:
                raise ValueError(f"{self.cfg.name} is decoder-only: it takes "
                                 f"no encoder frames")
            return transformer.init_decode_state(
                self.cfg, batch_size, seq_budget, self.device(params))
        if frames is None:
            raise ValueError("enc-dec decode needs encoder frames")
        frames = self.place_frames(params, frames)
        if frames.shape[0] != batch_size:
            raise ValueError(f"frames hold {frames.shape[0]} sequences, the "
                             f"batch {batch_size}")
        return encdec.init_decode_state(params, self.cfg, frames, seq_budget)

    def place_frames(self, params, frames) -> torch.Tensor:
        """Encoder frames on the device of ``params``: a NumPy array or a
        host tensor is copied there once; frames already there pass as
        they are. Frames on another card, or on a card when the params are
        on the host, raise: nothing is moved to the host unasked."""
        dev = self.device(params)
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        if frames.device == dev:
            return frames
        if frames.device.type != "cpu":
            raise ValueError(f"frames on {frames.device}, params on {dev}")
        return frames.to(dev)

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
