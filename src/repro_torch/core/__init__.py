"""DAISM core: the paper's contribution as composable torch functions."""
from .config import ALL_VARIANTS, Backend, DaismConfig, Variant, mantissa_bits
from .floatmul import approx_mul, approx_mul_to_f32
from .gemm import conv2d_im2col, daism_dot, daism_matmul
from .multiplier import (
    approx_mul_int_signmag,
    approx_mul_uint,
    approx_mul_uint_normalized,
    approx_mul_uint_planes,
    error_distance,
)

__all__ = [
    "ALL_VARIANTS",
    "Backend",
    "DaismConfig",
    "Variant",
    "mantissa_bits",
    "approx_mul",
    "approx_mul_to_f32",
    "conv2d_im2col",
    "daism_dot",
    "daism_matmul",
    "approx_mul_int_signmag",
    "approx_mul_uint",
    "approx_mul_uint_normalized",
    "approx_mul_uint_planes",
    "error_distance",
]
