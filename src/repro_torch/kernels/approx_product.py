"""Plain-torch twin of the CUDA kernel's in-kernel primitives.

``csrc/approx_product.cuh`` holds the same steps as ``__device__``
functions: the bf16 decomposition, the Table-1 approximate mantissa product
(the SRAM wired-OR read as a shift/OR chain on int32 lanes), and the f32
re-composition. This module spells them with tensor ops. It is what the
``pallas`` backend runs on CPU tensors and what ``chip_smoke.py`` holds the
kernel against on the card; both must stay bit-exact against
``kernels/ref.py`` per element.

:func:`approx_matmul_tile` sweeps K in :data:`K_FUSE`-wide sub-chunks and
folds each (M, K_FUSE, N) slab of products into the (M, N) f32
accumulator, so no (M, K, N) tensor is materialized.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import Variant

_BIAS = 127

# K-dim sub-chunk width of the fused sweep (the JAX package's value).
K_FUSE = 8


def decompose_bf16_i32(x: torch.Tensor):
    """bf16 -> (sign, exponent, mantissa-with-hidden-1) int32 fields."""
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    sign = bits >> 15
    exp = (bits >> 7) & 0xFF
    man = torch.where(exp > 0, (bits & 0x7F) | 0x80, 0)
    return sign, exp, man


def _bit(b, i):
    return (b >> i) & 1


def approx_mantissa_product(mw, mx, variant: Variant):
    """8-bit mantissa approximate product (int32), float mode (MSB set)."""
    base = variant.base
    if base is Variant.EXACT:
        out = mw * mx
    elif base is Variant.FLA:
        out = torch.zeros_like(mw * mx)
        for i in range(8):
            out = out | torch.where(_bit(mx, i) == 1, mw << i, 0)
    elif base is Variant.HLA:
        even = torch.zeros_like(mw * mx)
        odd = torch.zeros_like(even)
        for i in range(0, 8, 2):
            even = even | torch.where(_bit(mx, i) == 1, mw << i, 0)
        for i in range(1, 8, 2):
            odd = odd | torch.where(_bit(mx, i) == 1, mw << i, 0)
        out = even + odd
    elif base in (Variant.PC2, Variant.PC3):
        k = 2 if base is Variant.PC2 else 3
        w = _bit(mx, 7) | 1  # float mode: A always active
        for j in range(1, k):
            w = 2 * w + _bit(mx, 7 - j)
        out = (mw * w) << (8 - k)
        for i in range(0, 8 - k):
            out = out | torch.where(_bit(mx, i) == 1, mw << i, 0)
    else:  # pragma: no cover
        raise ValueError(variant)
    if variant.truncated:
        out = out & (0xFF << 8)
    return out


def compose_products_f32(x_fields, w_fields, variant: Variant) -> torch.Tensor:
    """Broadcast (sign, exp, man) field triples -> f32 approximate products.

    Normalization, exponent add, subnormal flush and inf saturation compose
    the f32 bits directly from integer fields.
    """
    sx3, ex3, mx3 = x_fields
    sw3, ew3, mw3 = w_fields
    prod = approx_mantissa_product(mw3, mx3, variant)
    top = (prod >> 15) & 1
    man = torch.where(top == 1, prod >> 8, prod >> 7) & 0xFF

    sign = sx3 ^ sw3
    exp = ex3 + ew3 - _BIAS + top
    zero = (mx3 == 0) | (mw3 == 0)
    exp = torch.where(zero, 0, exp)
    man = torch.where(zero, 0, man)
    is_zero = (man == 0) | (exp <= 0)
    is_inf = exp >= 255
    s = sign << 31  # INT_MIN for a negative sign: the f32 sign bit
    bits = s | (exp.clamp(0, 254) << 23) | ((man << 16) & 0x7FFFFF)
    bits = torch.where(is_zero, s, bits)
    bits = torch.where(is_inf & ~is_zero, s | 0x7F800000, bits)
    return bits.view(torch.float32)


def approx_matmul_tile(a: torch.Tensor, w: torch.Tensor, variant: Variant, *,
                       k_fuse: int = K_FUSE) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) bf16 -> (..., M, N) f32, fused shift/OR
    sweep over K; leading dims broadcast (the flash-attention plain version
    contracts every head at once).

    ``a`` is the multiplier (input), ``w`` the multiplicand (weight).
    Operand decomposition is hoisted out of the sweep.
    """
    variant = Variant(variant)
    m, k = a.shape[-2:]
    n = w.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-2], w.shape[:-2])
    sx, ex, mx = decompose_bf16_i32(a)   # (..., M, K)
    sw, ew, mw = decompose_bf16_i32(w)   # (..., K, N)
    acc = torch.zeros((*lead, m, n), dtype=torch.float32, device=a.device)
    for lo in range(0, k, k_fuse):
        hi = min(lo + k_fuse, k)
        slab = compose_products_f32(
            (sx[..., lo:hi, None], ex[..., lo:hi, None], mx[..., lo:hi, None]),
            (sw[..., None, lo:hi, :], ew[..., None, lo:hi, :],
             mw[..., None, lo:hi, :]),
            variant)
        acc = acc + slab.sum(dim=-2)
    return acc
