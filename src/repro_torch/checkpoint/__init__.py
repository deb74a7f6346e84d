"""Checkpoints on numpy, in the JAX package's on-disk layout."""

from .store import CheckpointStore, latest_step, restore, save

__all__ = ["CheckpointStore", "save", "restore", "latest_step"]
