"""Checkpoints of tensor trees, on the reference's on-disk layout."""
from repro_torch.checkpointing.checkpoint import latest, restore, save

__all__ = ["latest", "restore", "save"]
