"""Checkpointing of the port: the reference's on-disk format
(`ckpt/checkpoint.py`)."""
from repro_torch.ckpt.checkpoint import CheckpointManager, flatten

__all__ = ["CheckpointManager", "flatten"]
