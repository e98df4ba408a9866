"""Checkpointing (:mod:`repro_torch.train.checkpoint`). The trainer is a
later slice of the port (ROADMAP.md §1, item 6)."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
