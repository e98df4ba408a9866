"""Training: the fault-tolerant ``Trainer`` and atomic checkpointing."""
from .checkpoint import CheckpointManager
from .trainer import Trainer, TrainerConfig

__all__ = ["CheckpointManager", "Trainer", "TrainerConfig"]
