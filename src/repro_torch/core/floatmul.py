"""Approximate floating-point multiply built on the DAISM mantissa multiplier.

Paper §3.4: only the mantissa product is approximated. The implicit leading 1
is made explicit (so the ``A`` line is always active), exponents are added
exactly, signs are XOR'd, and the result is renormalized by a single top-bit
test (the approximate product is bounded by ``A <= p~ <= a*b`` so its leading
bit is at position 2n-1 or 2n-2).

Convention: ``w`` is the multiplicand (kernel element, stored in SRAM), ``x``
is the multiplier (input, drives wordline activation). FLA is
operand-symmetric; HLA/PC2/PC3 are not, so the order matters.

Products are returned as float32 for exact downstream accumulation. For
bfloat16 inputs the <=16-bit product mantissa is exact in f32. For float32
inputs with untruncated variants the 48-bit product is rounded toward zero
to 24 bits on conversion.
"""
from __future__ import annotations

import torch

from . import bitops
from .config import Variant, mantissa_bits
from .multiplier import approx_mul_uint, approx_mul_uint_planes

_BIAS = 127  # bf16 and f32 share the 8-bit exponent / bias-127 format


def _normalize_single(prod: torch.Tensor, n: int):
    """(product in [2^(2n-2), 2^2n)) -> (n-bit mantissa, exp bump)."""
    top = (prod >> (2 * n - 1)) & 1
    man = torch.where(top == 1, prod >> n, prod >> (n - 1))
    return man & ((1 << n) - 1), top


def _normalize_planes(hi: torch.Tensor, lo: torch.Tensor, n: int):
    top = (hi >> (n - 1)) & 1
    man_lo = ((hi << 1) | (lo >> (n - 1))) & ((1 << n) - 1)  # bits 2n-2..n-1
    man = torch.where(top == 1, hi, man_lo)
    return man & ((1 << n) - 1), top


def approx_mul_to_f32(x: torch.Tensor, w: torch.Tensor,
                      variant: Variant) -> torch.Tensor:
    """Elementwise approximate product of broadcastable x (input/multiplier)
    and w (weight/multiplicand), returned as float32."""
    variant = Variant(variant)
    if variant is Variant.EXACT:
        return x.to(torch.float32) * w.to(torch.float32)
    if x.dtype != w.dtype:
        raise ValueError(f"operand dtypes must match, got {x.dtype} vs {w.dtype}")
    n = mantissa_bits(x.dtype)

    sx, ex, mx = bitops.decompose(x)
    sw, ew, mw = bitops.decompose(w)
    sx, ex, mx, sw, ew, mw = torch.broadcast_tensors(sx, ex, mx, sw, ew, mw)

    if n <= 15:
        prod = approx_mul_uint(mw, mx, n, variant, msb_always_set=True)
        man, bump = _normalize_single(prod, n)
    else:
        hi, lo = approx_mul_uint_planes(mw, mx, n, variant, msb_always_set=True)
        man, bump = _normalize_planes(hi, lo, n)

    sign = sx ^ sw
    exp = ex + ew - _BIAS + bump
    man_f32 = man << (24 - n)
    zero = (mx == 0) | (mw == 0)
    exp = torch.where(zero, 0, exp)
    man_f32 = torch.where(zero, 0, man_f32)
    return bitops.compose_f32(sign, exp, man_f32)


def approx_mul(x: torch.Tensor, w: torch.Tensor, variant: Variant) -> torch.Tensor:
    """Elementwise approximate product, returned in the input dtype."""
    out = approx_mul_to_f32(x, w, Variant(variant))
    return out.to(x.dtype)
