"""Train step: microbatched gradient accumulation + AdamW.

The global batch is split into ``num_microbatches`` slices run one after
the other, accumulating grads in ``accum_dtype`` (fp32 default). Remat
lives inside the model's block loop. Gradient compression (bf16, or int8
with error feedback) optionally wraps the accumulated grads before the
optimizer. While a ``torch.profiler`` records, each microbatch's loss and
gradients run inside a ``train.microbatch`` host range and the AdamW update
inside ``train.update`` (``repro_torch/profiling.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.convert import reference_leaf_groups
from repro_torch.models.model_zoo import Model
from repro_torch.profiling import host_range
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import (
    OptConfig, adamw_update, leaves, like_layout)


def _split_microbatches(batch: Dict[str, torch.Tensor], nmb: int
                        ) -> List[Dict[str, torch.Tensor]]:
    for x in batch.values():
        if x.shape[0] % nmb:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"{nmb} microbatches")
    return [{k: v.chunk(nmb, dim=0)[i] for k, v in batch.items()}
            for i in range(nmb)]


def make_loss_and_grads(
    model: Model, num_microbatches: int = 1, accum_dtype=torch.float32,
    split: Callable = _split_microbatches,
) -> Callable:
    """Returns ``loss_and_grads(params, batch) -> (loss, grads, metrics)``;
    ``grads`` are in ``leaves(params)`` order. ``split(batch, nmb)`` gives
    the microbatches (the dry run's DTensor pass passes one that keeps each
    microbatch sharded over the batch axes)."""

    def loss_and_grads(params, batch) -> Tuple[torch.Tensor, List, Dict]:
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        try:
            nmb = max(1, num_microbatches)
            loss_sum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            acc = None
            metrics = {}
            for mb in split(batch, nmb):
                with host_range("train.microbatch"):
                    loss, metrics = model.loss(params, mb)
                    grads = torch.autograd.grad(loss, ps)
                if acc is None:
                    acc = [g.to(accum_dtype) for g in grads]
                else:
                    for a, g in zip(acc, grads):
                        a.add_(like_layout(g.to(accum_dtype), a))
                loss_sum = loss_sum + loss.detach()
                del grads, loss
        finally:
            for p in ps:
                p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if nmb == 1:
            return loss_sum, [a.float() for a in acc], metrics
        inv = 1.0 / nmb
        return loss_sum * inv, [(a * inv).float() for a in acc], metrics

    return loss_and_grads


def make_train_step(
    model: Model,
    opt_cfg: OptConfig,
    *,
    num_microbatches: int = 1,
    accum_dtype=torch.float32,
    compression: Optional[str] = None,        # None|"bf16"|"int8_ef"
    split: Callable = _split_microbatches,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch[, ef_state]) ->
    (params, opt_state, metrics[, ef_state])``; params and optimizer state
    are updated in place. With ``compression="int8_ef"`` the step takes the
    error-feedback residuals (``grad_compress.init_ef_state(leaves(
    params))``) and returns the new ones."""
    if compression not in (None, "bf16", "int8_ef"):
        raise ValueError(f"unknown compression {compression!r} "
                         f"(expected None, 'bf16' or 'int8_ef')")
    loss_and_grads = make_loss_and_grads(model, num_microbatches, accum_dtype,
                                         split)
    groups: List[List[int]] = []   # int8 scale groups, from the first step

    def train_step(params, opt_state, batch, ef_state=None):
        loss, grads, metrics = loss_and_grads(params, batch)
        if compression == "bf16":
            # the DP all-reduce would carry the bf16 grads
            grads = grad_compress.from_bf16(grad_compress.to_bf16(grads))
        elif compression == "int8_ef":
            if ef_state is None:
                raise ValueError("compression='int8_ef' needs ef_state")
            # one scale per reference leaf (a block position's layers share one)
            if not groups:
                groups.extend(reference_leaf_groups(params, model.cfg))
            _, grads, ef_state = grad_compress.ef_compress(
                grads, ef_state, groups)
        with host_range("train.update"):
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        if compression == "int8_ef":
            return params, opt_state, metrics, ef_state
        return params, opt_state, metrics

    return train_step
