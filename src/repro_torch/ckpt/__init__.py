"""Atomic, async checkpoints of flat dicts of tensors (`checkpoint`)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint"]
