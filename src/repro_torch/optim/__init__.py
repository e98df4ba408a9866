"""The port's optimizer: functional AdamW over dicts of tensors."""
from .adamw import (
    AdamWConfig, adamw_update, clip_by_global_norm, global_norm, init_adamw,
    make_train_step, schedule_lr,
)

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm", "global_norm",
           "init_adamw", "make_train_step", "schedule_lr"]
