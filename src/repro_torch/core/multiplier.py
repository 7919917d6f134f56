"""The DAISM approximate multiplier family (paper §3, Table 1).

Everything operates on unsigned n-bit operands held in int32 tensors; two
execution forms are provided, as in the JAX package:

* **single-word** (``n <= 15``): the 2n-bit product fits an int32 lane.
  Used for bfloat16 mantissas (n=8) and the INT8 error study.
* **dual-plane** (``n <= 24``): the 2n-bit product is carried as
  ``(hi, lo)`` int32 planes (see ``bitops``). Used for float32 (n=24).

The wordline naming follows the paper: ``A`` is the partial product with
shift ``n-1`` (multiplicand aligned to the multiplier's MSB), ``B`` shift
``n-2``, ..., ``H`` shift 0 for n=8.
"""
from __future__ import annotations

import torch

from . import bitops
from .bitops import Planes
from .config import Variant


def _mask(n: int) -> int:
    return (1 << n) - 1


def _bit(b: torch.Tensor, i: int) -> torch.Tensor:
    return (b >> i) & 1


def _head_bit(b: torch.Tensor, n: int, msb_always_set: bool) -> torch.Tensor:
    return _bit(b, n - 1) | 1 if msb_always_set else _bit(b, n - 1)


# ---------------------------------------------------------------------------
# Single-word path (n <= 15)
# ---------------------------------------------------------------------------

def _or_lines(a: torch.Tensor, b: torch.Tensor, shifts) -> torch.Tensor:
    """Wired-OR read: OR of ``a << i`` for every i in ``shifts`` with b_i=1."""
    acc = torch.zeros_like(a)
    for i in shifts:
        acc = acc | torch.where(_bit(b, i) == 1, a << i, 0)
    return acc


def approx_mul_uint(
    a: torch.Tensor,
    b: torch.Tensor,
    n: int,
    variant: Variant,
    *,
    integer_drop_lsb: bool = True,
    msb_always_set: bool = False,
) -> torch.Tensor:
    """Approximate product of unsigned n-bit ``a`` (multiplicand, stored in
    SRAM) and ``b`` (multiplier, drives wordline activation). n <= 15.

    ``msb_always_set`` is the float-mantissa mode (paper §3.4): the MSB of
    ``b`` is the implicit leading 1, so the ``A`` line is always active and
    no low line needs to be sacrificed for the pre-computed head lines.
    """
    if n > 15:
        raise ValueError("single-word path requires n <= 15; use the planes path")
    a, b = torch.broadcast_tensors(a.to(torch.int32), b.to(torch.int32))
    variant = Variant(variant)
    base = variant.base

    if base is Variant.EXACT:
        out = a * b
    elif base is Variant.FLA:
        out = _or_lines(a, b, range(n))
    elif base is Variant.HLA:
        even = _or_lines(a, b, range(0, n, 2))
        odd = _or_lines(a, b, range(1, n, 2))
        if variant.truncated:  # mask each *read* before the exact add
            tmask = _mask(n) << n
            even, odd = even & tmask, odd & tmask
            return (even + odd) & (_mask(n) << n)
        out = even + odd
    elif base in (Variant.PC2, Variant.PC3):
        k = 2 if base is Variant.PC2 else 3
        w = _head_bit(b, n, msb_always_set)
        for j in range(1, k):
            w = 2 * w + _bit(b, n - 1 - j)   # head weight in {0..2**k - 1}
        head = (a * w) << (n - k)             # exact pre-computed line content
        lo_start = 1 if (integer_drop_lsb and not msb_always_set) else 0
        out = head | _or_lines(a, b, range(lo_start, n - k))
    else:  # pragma: no cover
        raise ValueError(variant)

    if variant.truncated:
        out = out & (_mask(n) << n)
    return out


# ---------------------------------------------------------------------------
# Dual-plane path (n <= 24)
# ---------------------------------------------------------------------------

def _or_lines_planes(a: torch.Tensor, b: torch.Tensor, shifts, n: int) -> Planes:
    hi = torch.zeros_like(a)
    lo = torch.zeros_like(a)
    for i in shifts:
        phi, plo = bitops.planes_from_shift(a, i, n)
        sel = _bit(b, i) == 1
        hi = hi | torch.where(sel, phi, 0)
        lo = lo | torch.where(sel, plo, 0)
    return hi, lo


def approx_mul_uint_planes(
    a: torch.Tensor,
    b: torch.Tensor,
    n: int,
    variant: Variant,
    *,
    integer_drop_lsb: bool = True,
    msb_always_set: bool = False,
) -> Planes:
    """Dual-plane form of :func:`approx_mul_uint` for n <= 24 (float32)."""
    if n > 24:
        raise ValueError("dual-plane path requires n <= 24")
    a, b = torch.broadcast_tensors(a.to(torch.int32), b.to(torch.int32))
    variant = Variant(variant)
    base = variant.base

    if base is Variant.EXACT:
        out = bitops.exact_mul_planes(a, b, n)
    elif base is Variant.FLA:
        out = _or_lines_planes(a, b, range(n), n)
    elif base is Variant.HLA:
        even = _or_lines_planes(a, b, range(0, n, 2), n)
        odd = _or_lines_planes(a, b, range(1, n, 2), n)
        if variant.truncated:
            even = bitops.planes_truncate_top(even, n)
            odd = bitops.planes_truncate_top(odd, n)
        out = bitops.planes_add(even, odd, n)
    elif base in (Variant.PC2, Variant.PC3):
        k = 2 if base is Variant.PC2 else 3
        w = _head_bit(b, n, msb_always_set)
        for j in range(1, k):
            w = 2 * w + _bit(b, n - 1 - j)
        head = bitops.planes_from_scaled(a * w, n - k, n)
        lo_start = 1 if (integer_drop_lsb and not msb_always_set) else 0
        low = _or_lines_planes(a, b, range(lo_start, n - k), n)
        out = bitops.planes_or(head, low)
    else:  # pragma: no cover
        raise ValueError(variant)

    if variant.truncated:
        out = bitops.planes_truncate_top(out, n)
    return out


# ---------------------------------------------------------------------------
# Paper Eq. (3): shift-normalized small-multiplier fix for PC2/PC3
# ---------------------------------------------------------------------------

def approx_mul_uint_normalized(
    a: torch.Tensor, b: torch.Tensor, n: int, variant: Variant
) -> torch.Tensor:
    """c = (a * (b << s)) >> s with s chosen so b's MSB is set (paper Eq. 3).

    The paper identifies PC2/PC3's large error for small multipliers (the
    sacrificed LSB line + inactive head lines) and *suggests* this shift
    normalization without evaluating it. As in the JAX package, small
    multipliers are pre-shifted into the MSB-active operating region and
    the wired-OR result is shifted back: one leading-zero count + two
    shifts in the address decoder / output mux.
    """
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    # leading-zero count of b within n bits (b==0 handled at the end)
    s = torch.zeros_like(b)
    bb = b
    for step in (8, 4, 2, 1):  # unrolled CLZ within n bits
        if step < 2 * n:
            take = ((bb << step) < (1 << n)).to(torch.int32) * step
            take = torch.where(bb == 0, 0, take)
            bb = torch.where(take > 0, bb << step, bb)
            s = s + take
    out = approx_mul_uint(a, bb, n, variant, msb_always_set=True)
    out = out >> s
    return torch.where(b == 0, 0, out)


# ---------------------------------------------------------------------------
# Signed wrapper (paper §3.1: sign-magnitude, NOT two's complement)
# ---------------------------------------------------------------------------

def approx_mul_int_signmag(
    a: torch.Tensor, b: torch.Tensor, n: int, variant: Variant, **kw
) -> torch.Tensor:
    """Signed approximate multiply using sign-magnitude operands (n<=15)."""
    sign = torch.sign(a.to(torch.int32)) * torch.sign(b.to(torch.int32))
    mag = approx_mul_uint(a.abs(), b.abs(), n, variant, **kw)
    return sign * mag


# ---------------------------------------------------------------------------
# Error metric (paper Eq 2)
# ---------------------------------------------------------------------------

def error_distance(exact: torch.Tensor, approx: torch.Tensor) -> torch.Tensor:
    """ED = |r - r'| / max(r, 1)."""
    exact_f = exact.to(torch.float32)
    return (exact_f - approx.to(torch.float32)).abs() / exact_f.clamp(min=1.0)
