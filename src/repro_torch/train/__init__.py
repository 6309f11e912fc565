"""Training substrate: optimizer, microbatched step, checkpointing, faults."""
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state, leaves, lr_at
from repro_torch.train.train_step import make_loss_and_grads, make_train_step
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    host_copy,
    load_into,
    restore_arrays,
    restore_sharded,
    restore_tree,
    save_checkpoint,
)
from repro_torch.train.fault import FaultInjected, StepSupervisor
from repro_torch.train import grad_compress

__all__ = [
    "OptConfig",
    "adamw_update",
    "init_opt_state",
    "leaves",
    "lr_at",
    "make_loss_and_grads",
    "make_train_step",
    "AsyncCheckpointer",
    "host_copy",
    "load_into",
    "restore_arrays",
    "restore_sharded",
    "restore_tree",
    "save_checkpoint",
    "FaultInjected",
    "StepSupervisor",
    "grad_compress",
]
