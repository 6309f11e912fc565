"""Model facade: one interface over the decoder-only stack (global and
local attention blocks with dense or Mixture-of-Experts FFNs,
attention-free Mamba-1 blocks and Griffin's RG-LRU blocks; token or
patch-embedding input) and the encoder-decoder stack (whisper), picked by
``cfg.is_encdec`` as in the reference.

Also home of ``abstract_params`` / ``input_specs`` / ``decode_state_specs``:
the stand-ins the dry run (``launch/dryrun.py``) runs the model on, meta
tensors in the port's own trees (no allocation, no random draw)."""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import init_cache

_META = torch.device("meta")


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

    def abstract_params(self) -> Dict[str, Any]:
        """The params' tree on the meta device: every leaf's shape and
        dtype, nothing allocated, no number drawn (``layers.normal_init``
        reads no generator on meta)."""
        return self._m.init_model(None, self.cfg, _META)

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

    # -- dry-run specs ------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The batch of one step of ``shape`` as meta tensors, the
        reference's ``input_specs``: int32 tokens and labels (as the
        pipeline delivers them), embeddings in the compute dtype."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        act = transformer._DTYPES[cfg.dtype]
        d = cfg.d_model

        def ids(*s):
            return torch.empty(s, dtype=torch.int32, device=_META)

        if shape.kind == "decode":
            return {"tokens": ids(B, 1)}
        if cfg.is_encdec:
            batch = {"embeds": torch.empty((B, cfg.encoder_seq, d), dtype=act,
                                           device=_META),
                     "tokens": ids(B, S)}
        elif cfg.input_mode == "embeddings":
            batch = {"embeds": torch.empty((B, S, d), dtype=act, device=_META)}
            if cfg.mrope_sections:
                batch["positions"] = torch.empty((B, S, 3), dtype=torch.int32,
                                                 device=_META)
        else:
            batch = {"tokens": ids(B, S)}
        if shape.kind == "train":
            batch["labels"] = ids(B, S)
        return batch

    def decode_state_specs(self, shape: ShapeConfig):
        """The decode state of a ``decode_*`` shape on meta: a cache of
        ``seq_len`` slots a global layer (the window's a local one) at
        ``pos = seq_len - 1``, the last slot, so that the step attends over
        every slot the reference's slot mask keeps. Encoder-decoder: the
        self-attention rings and each layer's cross (k, v) over
        ``encoder_seq`` frames, without running the encoder."""
        if shape.kind != "decode":
            raise ValueError(f"decode_state_specs of a {shape.kind} shape")
        cfg = self.cfg
        B, budget = shape.global_batch, shape.seq_len
        if not cfg.is_encdec:
            return transformer.init_decode_state(cfg, B, budget, _META,
                                                 pos=budget - 1)
        dt = transformer._DTYPES[cfg.dtype]
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        kv = lambda: torch.empty((B, cfg.encoder_seq, K, hd), dtype=dt,  # noqa: E731
                                 device=_META)
        return encdec.EncDecState(
            self_caches=[init_cache(B, budget, K, hd, dt, _META)
                         for _ in range(cfg.num_layers)],
            cross_kv=[(kv(), kv()) for _ in range(cfg.num_layers)],
            pos=budget - 1)

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
