"""Checkpoints of tensor trees, on the reference's on-disk layout."""
from repro_torch.checkpointing.checkpoint import (CheckpointManager, latest,
                                                  restore, save)

__all__ = ["CheckpointManager", "latest", "restore", "save"]
