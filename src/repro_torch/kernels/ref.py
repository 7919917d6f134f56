"""Plain-torch oracle for the DAISM GEMM kernel.

``daism_matmul_ref`` is the normative semantics: exact f32 accumulation of
per-element approximate products from ``core.floatmul``.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import Variant
from repro_torch.core.floatmul import approx_mul_to_f32


def daism_matmul_ref(a: torch.Tensor, w: torch.Tensor,
                     variant: Variant) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) f32. Materializes (M, K, N); test-scale only."""
    variant = Variant(variant)
    if variant is Variant.EXACT:
        return a.to(torch.float32) @ w.to(torch.float32)
    prod = approx_mul_to_f32(a[:, :, None], w[None, :, :], variant)
    return prod.sum(dim=1)
