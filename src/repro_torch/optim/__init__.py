"""AdamW with an f32 master copy, and learning-rate schedules."""
from .adamw import AdamWConfig, AdamWState, apply_updates, init_state
from .schedule import cosine_with_warmup, linear_warmup

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "init_state",
           "cosine_with_warmup", "linear_warmup"]
