"""Checkpoints in the JAX package's on-disk layout (``manager.py``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
