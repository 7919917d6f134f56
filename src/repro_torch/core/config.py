"""DAISM configuration objects.

A :class:`DaismConfig` fully determines the numerics of the approximate
multiplier (paper Table 1) plus the execution backend used to realize it.
It is a frozen, hashable dataclass, so it keys the dispatcher's caches.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Variant(str, enum.Enum):
    """Multiplier variants from paper Table 1 (+ exact baseline)."""

    EXACT = "exact"    # carry-propagating baseline multiplier
    FLA = "fla"        # full lines activation: OR of all selected partial products
    HLA = "hla"        # half lines activation: 2 reads (even/odd shifts), exact add
    PC2 = "pc2"        # pre-computed A+B head line
    PC3 = "pc3"        # pre-computed combos of A,B,C head line
    PC2_TR = "pc2_tr"  # PC2 + truncation to top-n columns
    PC3_TR = "pc3_tr"  # PC3 + truncation to top-n columns

    @property
    def truncated(self) -> bool:
        return self in (Variant.PC2_TR, Variant.PC3_TR)

    @property
    def base(self) -> "Variant":
        return {
            Variant.PC2_TR: Variant.PC2,
            Variant.PC3_TR: Variant.PC3,
        }.get(self, self)

    @property
    def memory_reads(self) -> int:
        """Paper Table 1: number of SRAM reads per multiplication."""
        return 2 if self is Variant.HLA else 1


class Backend(str, enum.Enum):
    """Execution strategy for the approximate GEMM."""

    JNP = "jnp"              # plain torch bit ops, K-chunked (reference / oracle)
    LUT = "lut"              # bf16-only: 128x128 precomputed mantissa-product table
    PALLAS = "pallas"        # the hand-written CUDA kernel (plain tile version on CPU)
    EXACT = "exact"          # plain matmul (deployment path)


_MANTISSA_BITS = {"bfloat16": 8, "float32": 24}


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` / ``"bfloat16"`` -> ``"bfloat16"`` (the names the
    JAX package's errors and reports use)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` -> ``torch.bfloat16``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@dataclasses.dataclass(frozen=True)
class DaismConfig:
    """Static numerics + backend configuration.

    Attributes:
      variant: which approximate multiplier (paper Table 1).
      backend: how to execute it.
      integer_drop_lsb: in *integer* PC2 mode, whether the LSB partial-product
        line ``H`` is sacrificed to make room for the pre-computed ``A+B``
        line (paper Fig 3). Float mode never drops lines because the
        mantissa MSB is always 1 (paper 3.4).
      accum_dtype: exact accumulator dtype used by the GEMM reduction.
      backward: 'ste' uses exact gradients (straight-through), 'approx'
        routes the backward GEMMs through the approximate multiplier too.
      k_chunk: K-dim chunk size used by the jnp backend to bound the
        materialized (M, Kc, N) intermediate.
      block_m/block_n/block_k: tiling knobs of the JAX package's Pallas
        kernel, kept so configs hash and print alike in both packages; the
        CUDA kernel has its own fixed tile.
      interpret: kept for parity with the JAX package's configs. It selects
        nothing here: the operands' device alone picks the CUDA kernel (CUDA
        tensors) or its plain version (CPU tensors).
      attn_kernel: how attention-score sites (OpKind.ATTN_QK) execute.
        'jnp' keeps the exact online-softmax path; 'flash' selects the fused
        flash-attention kernel, which is not ported yet.
    """

    variant: Variant = Variant.PC3_TR
    backend: Backend = Backend.JNP
    integer_drop_lsb: bool = True
    accum_dtype: str = "float32"
    backward: str = "ste"  # 'ste' | 'approx'
    calibrated: bool = False  # beyond-paper: unbias the one-sided shrinkage
    k_chunk: int = 64
    block_m: int = 32
    block_n: int = 128
    block_k: int = 128
    interpret: Optional[bool] = None
    attn_kernel: str = "jnp"  # 'jnp' | 'flash' (attention-score sites only)

    def __post_init__(self) -> None:
        if self.backward not in ("ste", "approx"):
            raise ValueError(f"backward must be 'ste'|'approx', got {self.backward}")
        if self.attn_kernel not in ("jnp", "flash"):
            raise ValueError(
                f"attn_kernel must be 'jnp'|'flash', got {self.attn_kernel!r}")
        if self.accum_dtype not in _MANTISSA_BITS:
            raise ValueError(
                f"accum_dtype must be one of {sorted(_MANTISSA_BITS)}, got "
                f"{self.accum_dtype!r}")
        if self.k_chunk < 1:
            raise ValueError(f"k_chunk must be >= 1, got {self.k_chunk}")
        if min(self.block_m, self.block_n, self.block_k) < 1:
            raise ValueError(
                "pallas block sizes must be >= 1, got "
                f"(block_m={self.block_m}, block_n={self.block_n}, "
                f"block_k={self.block_k})")
        if (self.backend is Backend.PALLAS and not self.exact
                and self.backward == "approx"):
            raise ValueError(
                "backend 'pallas' has no approximate backward kernel; use "
                "backward='ste' (exact gradients) or backend='jnp'")

    def validate_for_dtype(self, dtype, *, site: str = "") -> None:
        """Check this config can run on ``dtype`` operands; see
        policy.dispatch."""
        from repro_torch.policy.dispatch import validate_for_dtype

        validate_for_dtype(self, dtype, site=site)

    @property
    def exact(self) -> bool:
        return self.variant is Variant.EXACT or self.backend is Backend.EXACT

    def replace(self, **kw) -> "DaismConfig":
        return dataclasses.replace(self, **kw)


def mantissa_bits(dtype) -> int:
    """Effective mantissa width (including the implicit leading 1)."""
    name = dtype_name(dtype)
    if name not in _MANTISSA_BITS:
        raise ValueError(f"DAISM supports bfloat16/float32, got {name}")
    return _MANTISSA_BITS[name]


# Canonical configs used throughout benchmarks/tests (paper Table 1 order).
ALL_VARIANTS = (
    Variant.FLA,
    Variant.HLA,
    Variant.PC2,
    Variant.PC3,
    Variant.PC2_TR,
    Variant.PC3_TR,
)
