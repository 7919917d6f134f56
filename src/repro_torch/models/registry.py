"""Model registry: family -> model class (dense decoder LMs so far)."""
from __future__ import annotations

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
