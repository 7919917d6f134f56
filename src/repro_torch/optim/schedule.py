"""LR schedules (pure functions of the step counter)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_with_warmup(step, *, warmup: int = 1000, total: int = 100_000,
                       min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
    return warm * cos


def linear_warmup(step, *, warmup: int = 1000) -> torch.Tensor:
    return torch.clamp(_f32(step) / max(warmup, 1), max=1.0)
