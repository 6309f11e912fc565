"""Training substrate: optimizer and microbatched train step."""
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state, leaves, lr_at
from repro_torch.train.train_step import make_loss_and_grads, make_train_step

__all__ = [
    "OptConfig",
    "adamw_update",
    "init_opt_state",
    "leaves",
    "lr_at",
    "make_loss_and_grads",
    "make_train_step",
]
