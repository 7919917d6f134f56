"""Model registry: family -> model class (dense decoder LMs so far), plus
the shared LM loss."""
from __future__ import annotations

import torch

from .common import ArchConfig
from .transformer import DecoderLM

_FAMILIES = {"dense": DecoderLM}


def build_model(cfg: ArchConfig, device="cuda"):
    """The model for ``cfg``, allocating on ``device`` (default: the card)."""
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} (arch {cfg.name}) is not ported yet; "
            f"ported families: {sorted(_FAMILIES)}") from None
    return cls(cfg, device=device)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, aux=0.0,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross entropy in f32 (+ MoE load-balance aux)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.mean() + aux_weight * aux
