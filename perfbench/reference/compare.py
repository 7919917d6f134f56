"""The numbers that decide ``correct``, from the program's outputs and the
reference's."""
from __future__ import annotations

import torch


def row_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest, over rows, of ``|got - ref| / |ref|`` (2-norms over the
    last dim): one altered row shows whole."""
    g, r = got.float().flatten(0, -2), ref.float().flatten(0, -2)
    num = torch.linalg.vector_norm(g - r, dim=-1)
    den = torch.linalg.vector_norm(r, dim=-1).clamp(min=1e-30)
    return float((num / den).max())


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``|got - ref| / |ref|`` over every element."""
    g, r = got.float(), ref.float()
    return float(torch.linalg.vector_norm(g - r)
                 / torch.linalg.vector_norm(r).clamp(min=1e-30))

