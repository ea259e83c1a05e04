"""Atomic, manifest-driven checkpoints of tensor trees."""

from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                 CheckpointCorruptError)

__all__ = ["Checkpointer", "CheckpointCorruptError"]
