"""Synthetic data pipelines (numpy generators, copied from the JAX package)."""
from .synthetic import eval_set, image_batches, lm_batches, shard_batch

__all__ = ["eval_set", "image_batches", "lm_batches", "shard_batch"]
