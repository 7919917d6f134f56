"""bf16 mantissa-product lookup table (beyond-paper fast path).

For bfloat16 the effective mantissa is 8 bits with the MSB always set, so
there are only 128 x 128 = 16,384 distinct mantissa pairs. The 16-bit
approximate product of every pair is computed once per variant into an
int32 table, turning the shift/OR chain into one gather. Numerics are
bit-identical to the bit-op path (asserted in the tests).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import bitops
from .config import Variant
from .multiplier import approx_mul_uint

_BIAS = 127


@functools.lru_cache(maxsize=None)
def mantissa_product_table(variant: Variant) -> np.ndarray:
    """(128, 128) int32 table: T[mw-128, mx-128] = approx product (16-bit)."""
    mw = torch.arange(128, 256, dtype=torch.int32)[:, None]
    mx = torch.arange(128, 256, dtype=torch.int32)[None, :]
    t = approx_mul_uint(mw, mx, 8, Variant(variant), msb_always_set=True)
    return t.numpy().astype(np.int32)


@functools.lru_cache(maxsize=None)
def shrinkage_factor(variant: Variant) -> float:
    """E[approx/exact] over uniform mantissa pairs (beyond-paper calibration).

    DAISM products are one-sided (approx <= exact): a GEMM output is
    systematically shrunk by ~E[ratio]; dividing by this constant removes
    the bias.
    """
    t = mantissa_product_table(Variant(variant)).astype(np.float64)
    mw = np.arange(128, 256, dtype=np.float64)[:, None]
    mx = np.arange(128, 256, dtype=np.float64)[None, :]
    return float((t / (mw * mx)).mean())


def approx_mul_to_f32_lut(x: torch.Tensor, w: torch.Tensor,
                          variant: Variant) -> torch.Tensor:
    """bf16-only elementwise approximate product via table gather -> f32.

    Bit-identical to ``floatmul.approx_mul_to_f32`` for bfloat16 operands.
    """
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("LUT path is bfloat16-only")
    table = torch.from_numpy(mantissa_product_table(Variant(variant))).to(x.device)
    sx, ex, mx = bitops.decompose(x)
    sw, ew, mw = bitops.decompose(w)
    sx, ex, mx, sw, ew, mw = torch.broadcast_tensors(sx, ex, mx, sw, ew, mw)

    idx = ((mw - 128).clamp(min=0) << 7) | (mx - 128).clamp(min=0)
    prod = table.reshape(-1)[idx.long()]
    top = (prod >> 15) & 1
    man = torch.where(top == 1, prod >> 8, prod >> 7) & 0xFF

    sign = sx ^ sw
    exp = ex + ew - _BIAS + top
    man_f32 = man << 16
    zero = (mx == 0) | (mw == 0)
    exp = torch.where(zero, 0, exp)
    man_f32 = torch.where(zero, 0, man_f32)
    return bitops.compose_f32(sign, exp, man_f32)
