"""Bit-level primitives for the DAISM multiplier family.

The paper's partial-product space for a float32 mantissa multiply is 48 bits
wide. As in the JAX package, 2n-bit words (n = mantissa width) are carried
as a **dual plane** ``(hi, lo)`` of int32 values, each holding ``n`` bits
(``value = hi * 2**n + lo``). The wired-OR reduction is carry-free, so
OR-accumulation never crosses the plane boundary; the few exact adds the
variants need carry at most one bit across, which is propagated explicitly.
Keeping the int32 planes (torch has int64, but the planes are what the JAX
package computes) makes every result equal bit for bit.

Bit casts: torch has no full uint16/uint32 arithmetic. ``bf16.view(int16)``
sign-extends, so the bits are masked with ``0xFFFF``; f32 bits are built in
int32, where ``1 << 31`` is ``INT_MIN`` and views as ``-0.0``.

All functions are elementwise on broadcastable int32 tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

Planes = Tuple[torch.Tensor, torch.Tensor]  # (hi, lo), each int32 holding n bits


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x`` (shared padding helper)."""
    return (x + m - 1) // m * m


def _mask(n: int) -> int:
    return (1 << n) - 1


# ---------------------------------------------------------------------------
# Dual-plane algebra (value = hi * 2**n + lo, 0 <= hi, lo < 2**n, n <= 24)
# ---------------------------------------------------------------------------

def planes_from_shift(a: torch.Tensor, i: int, n: int) -> Planes:
    """Return ``a << i`` as dual planes, for 0 <= a < 2**n, 0 <= i < n."""
    if i == 0:
        return torch.zeros_like(a), a
    lo = (a & _mask(n - i)) << i
    hi = a >> (n - i)
    return hi, lo


def planes_or(x: Planes, y: Planes) -> Planes:
    return x[0] | y[0], x[1] | y[1]


def planes_add(x: Planes, y: Planes, n: int) -> Planes:
    """Exact add of two dual-plane values (carry propagates across planes)."""
    lo = x[1] + y[1]
    carry = lo >> n
    return x[0] + y[0] + carry, lo & _mask(n)


def planes_from_scaled(a_times_w: torch.Tensor, shift: int, n: int) -> Planes:
    """Planes of ``a_times_w << shift`` where ``a_times_w`` fits int32
    (the pre-computed head lines: ``(A+B) = 3a << (n-2)`` etc.)."""
    if shift < n:
        lo = (a_times_w & _mask(max(n - shift, 0))) << shift
        hi = a_times_w >> (n - shift)
    else:
        lo = torch.zeros_like(a_times_w)
        hi = a_times_w << (shift - n)
    return hi & 0x7FFFFFFF, lo


def planes_truncate_top(x: Planes, n: int) -> Planes:
    """Keep only the top-n columns (bits 2n-1 .. n) => zero the low plane."""
    return x[0], torch.zeros_like(x[1])


def exact_mul_planes(a: torch.Tensor, b: torch.Tensor, n: int) -> Planes:
    """Exact 2n-bit product of n-bit unsigned a, b as dual planes (int32-only).

    Splits each operand into 12-bit halves so every partial product fits in
    int32. Valid for n <= 24.
    """
    if n > 24:
        raise ValueError("dual-plane exact multiply supports n <= 24")
    h = 12
    al, ah = a & _mask(h), a >> h
    bl, bh = b & _mask(h), b >> h
    low = al * bl
    mid = ah * bl + al * bh
    high = ah * bh
    lo_acc = low + ((mid & _mask(h)) << h)
    hi_acc = high + (mid >> h) + (lo_acc >> 24)
    lo24 = lo_acc & _mask(24)
    if n == 24:
        return hi_acc, lo24
    hi = (hi_acc << (24 - n)) | (lo24 >> n)
    lo = lo24 & _mask(n)
    return hi, lo


# ---------------------------------------------------------------------------
# Float (de)composition
# ---------------------------------------------------------------------------

def decompose_bf16(x: torch.Tensor):
    """bf16 -> (sign, biased_exp, mantissa_with_implicit_1) int32 each.

    Subnormals are flushed (treated as zero): exp==0 => mantissa 0.
    """
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    sign = bits >> 15
    exp = (bits >> 7) & 0xFF
    frac = bits & 0x7F
    man = torch.where(exp > 0, frac | 0x80, torch.zeros_like(frac))
    return sign, exp, man


def compose_bf16(sign: torch.Tensor, exp: torch.Tensor,
                 man: torch.Tensor) -> torch.Tensor:
    """(sign, biased_exp, 8-bit mantissa incl. leading 1) -> bf16.

    exp <= 0 flushes to zero; exp >= 255 saturates to inf. man==0 => zero.
    """
    zero = (man == 0) | (exp <= 0)
    inf = exp >= 255
    exp_c = exp.clamp(0, 254)
    bits = (sign << 15) | (exp_c << 7) | (man & 0x7F)
    bits = torch.where(zero, sign << 15, bits)
    bits = torch.where(inf & ~zero, (sign << 15) | (0xFF << 7), bits)
    # fold the uint16 pattern into int16 range before the view
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(torch.int16).view(torch.bfloat16)


def decompose_f32(x: torch.Tensor):
    """f32 -> (sign, biased_exp, 24-bit mantissa incl. leading 1) int32."""
    bits = x.contiguous().view(torch.int32)
    sign = (bits >> 31) & 1
    exp = (bits >> 23) & 0xFF
    frac = bits & 0x7FFFFF
    man = torch.where(exp > 0, frac | (1 << 23), torch.zeros_like(frac))
    return sign, exp, man


def compose_f32(sign: torch.Tensor, exp: torch.Tensor,
                man: torch.Tensor) -> torch.Tensor:
    """(sign, biased_exp, 24-bit mantissa) -> f32, flushing exp <= 0 or a
    zero mantissa to a signed zero and saturating exp >= 255 to inf."""
    zero = (man == 0) | (exp <= 0)
    inf = exp >= 255
    exp_c = exp.clamp(0, 254)
    s = sign << 31  # INT_MIN for a negative sign: the f32 sign bit
    bits = s | (exp_c << 23) | (man & 0x7FFFFF)
    bits = torch.where(zero, s, bits)
    bits = torch.where(inf & ~zero, s | 0x7F800000, bits)
    return bits.view(torch.float32)


def decompose(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return decompose_bf16(x)
    if x.dtype == torch.float32:
        return decompose_f32(x)
    raise ValueError(f"unsupported dtype {x.dtype}")


def compose(sign, exp, man, dtype):
    if dtype == torch.bfloat16:
        return compose_bf16(sign, exp, man)
    if dtype == torch.float32:
        return compose_f32(sign, exp, man)
    raise ValueError(f"unsupported dtype {dtype}")
