"""Atomic, resumable checkpoints in the JAX package's on-disk format."""
from .checkpoint import SENTINEL, cleanup, latest_step, restore, save

__all__ = ["SENTINEL", "cleanup", "latest_step", "restore", "save"]
