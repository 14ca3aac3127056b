"""Checkpoint substrate: atomic save/restore, retention, validated restore."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
