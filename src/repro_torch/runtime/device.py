"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and run on the CPU only when the caller
asks for it. A CUDA request on a machine without a usable card raises: the
port never carries on on the CPU in its place.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in (``"cuda"``
    -> ``cuda:<current>``, the device tensors report); raises if it names
    CUDA and no card is available. ``meta`` (shapes only, nothing runs)
    is what the dry-run asks for by name."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu, or "
                         "meta for a shape-only trace)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
