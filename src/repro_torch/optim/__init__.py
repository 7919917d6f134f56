"""AdamW with an f32 master copy, and learning-rate schedules."""
from .adamw import (AdamWConfig, AdamWState, apply_updates, global_norm,
                    init_state, state_axes)
from .schedule import cosine_with_warmup, linear_warmup

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "global_norm",
           "init_state", "state_axes",
           "cosine_with_warmup", "linear_warmup"]
