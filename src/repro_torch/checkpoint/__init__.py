"""Checkpoints of the port's training (port of ``repro.checkpoint``)."""

from .ckpt import (AsyncCheckpointer, latest_checkpoint, restore_checkpoint,
                   save_checkpoint, state_arrays)

__all__ = ["AsyncCheckpointer", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint", "state_arrays"]
