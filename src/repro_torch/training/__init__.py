from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (
    AdamWConfig, OptState, adamw_update, cosine_lr, init_opt_state,
)
from repro_torch.training.train_step import check_trainable, init_train_state, make_train_step

__all__ = [
    "AdamWConfig", "OptState", "adamw_update", "cosine_lr", "init_opt_state",
    "make_train_step", "init_train_state", "check_trainable", "save_checkpoint",
    "restore_checkpoint",
]
