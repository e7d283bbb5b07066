"""Fault-tolerant checkpointing (atomic, hashed, async)."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
