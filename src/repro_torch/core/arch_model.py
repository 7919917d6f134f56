"""Analytical cycle/area model of the DAISM accelerator (paper §5.3, Fig 9).

A copy of the JAX package's ``repro/core/arch_model.py`` (plain Python
arithmetic, so both packages give equal numbers).

Models the banked wired-OR SRAM architecture of Fig 4 executing a conv layer
(im2col GEMM view) and an Eyeriss-style 168-PE row-stationary baseline, the
way the paper does with Timeloop/Accelergy. Area constants are 45nm,
component-composed (SRAM macro area + PE/accumulator/decoder overheads) and
recorded explicitly; we validate the paper's *relative* Fig-9 geometry:

  * 1 x 512 kB bank: slowest (row under-utilization), largest SRAM area;
  * splitting into banks multiplies throughput (different inputs per bank);
  * 16 x 8 kB matches 4 x 128 kB cycles at the smallest area;
  * banked DAISM beats 168-PE Eyeriss in cycles at comparable area
    (headline: −43 % cycles, −25 % energy under similar constraints).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from . import energy as E
from .config import Variant


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """NHWC conv layer; defaults are VGG-8 layer 1 (paper §5.3: 224x224x3
    input, 3x3x3x64 kernel => 150,528 inputs / 1,728 kernel elements)."""

    h: int = 224
    w: int = 224
    cin: int = 3
    cout: int = 64
    kh: int = 3
    kw: int = 3
    stride: int = 1

    @property
    def out_pixels(self) -> int:
        return (self.h // self.stride) * (self.w // self.stride)

    @property
    def k_rows(self) -> int:  # im2col contraction length
        return self.kh * self.kw * self.cin

    @property
    def kernel_elements(self) -> int:
        return self.k_rows * self.cout

    @property
    def inputs(self) -> int:
        return self.h * self.w * self.cin

    @property
    def macs(self) -> int:
        return self.out_pixels * self.k_rows * self.cout


@dataclasses.dataclass(frozen=True)
class BankConfig:
    """Square SRAM banks (paper: square for manufacturability)."""

    num_banks: int = 16
    bank_kbytes: int = 32

    @property
    def bits(self) -> int:
        return self.bank_kbytes * 1024 * 8

    @property
    def side(self) -> int:  # square array: side x side bits
        return int(math.isqrt(self.bits))

    @property
    def bus_bits(self) -> int:
        return self.side

    def elements_per_row(self, dtype: str, truncated: bool) -> int:
        return E.concurrent_mults(dtype, truncated, self.bus_bits)

    @property
    def total_kbytes(self) -> int:
        return self.num_banks * self.bank_kbytes


# Paper's evaluated configurations (Fig 9) -------------------------------
FIG9_CONFIGS = (
    BankConfig(1, 512),
    BankConfig(4, 128),
    BankConfig(16, 32),
    BankConfig(16, 8),
)


# ---------------------------------------------------------------------------
# Cycles
# ---------------------------------------------------------------------------

def daism_cycles(
    layer: ConvLayer,
    banks: BankConfig,
    variant: Variant = Variant.PC3_TR,
    dtype: str = "bfloat16",
) -> Dict[str, float]:
    """Cycle count for the banked DAISM array on one conv layer.

    Each cycle a bank performs one multi-wordline read: 1 input value x
    `epr` kernel elements of one logical row. A kernel-matrix row (cout
    elements sharing the same input) spans ceil(cout/epr) logical rows; if
    cout < epr the remaining row slots hold other kernel rows which need a
    *different* input => utilization cout/epr (paper: "some input elements
    must not be multiplied by all kernel elements, which decreases
    utilization").
    """
    variant = Variant(variant)
    epr = banks.elements_per_row(dtype, variant.truncated)
    reads_per_input_row = max(1, math.ceil(layer.cout / epr))
    utilization = min(1.0, layer.cout / epr)
    reads = layer.out_pixels * layer.k_rows * reads_per_input_row
    reads *= variant.memory_reads  # HLA: 2 reads per multiplication
    cycles = reads / banks.num_banks
    # capacity: does the kernel fit? (lines per element x field bits)
    n = E.mantissa_width(dtype)
    lines = E.active_wordlines(variant, dtype) + (1 if variant.base in
                                                  (Variant.PC2, Variant.PC3) else 0)
    field = 2 * E.product_bits(dtype, variant.truncated)
    elem_bits = lines * field
    capacity_elems = banks.num_banks * banks.bits // elem_bits
    refills = max(1, math.ceil(layer.kernel_elements / capacity_elems))
    return {
        "cycles": cycles * refills,
        "utilization": utilization,
        "elements_per_row": epr,
        "pe_equivalent": banks.num_banks * epr,
        "refills": refills,
    }


def eyeriss_cycles(layer: ConvLayer, num_pes: int = 168) -> Dict[str, float]:
    """Row-stationary 168-PE baseline at ideal utilization (paper grants
    Eyeriss its best case, as we do not model its mapping losses)."""
    return {
        "cycles": layer.macs / num_pes,
        "utilization": 1.0,
        "pe_equivalent": num_pes,
    }


# ---------------------------------------------------------------------------
# Area (45nm)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AreaModel:
    """45nm component areas.

    * SRAM macro: ~0.45 um^2/bit incl. periphery at 45nm (CACTI-order);
    * bf16 truncated multiplier: ~1600 um^2 (scaled from Yin'16 fp32 synth
      with the same truncation-linear scaling as the energy model);
    * accumulator + exponent handler per concurrent output: ~500 um^2;
    * RF/scratchpad: ~1.1 um^2/bit; decoder+bus overhead: 8 % of SRAM.
    """

    sram_um2_per_bit: float = 0.45
    mult_bf16_um2: float = 1600.0
    accum_um2: float = 500.0
    rf_um2_per_bit: float = 1.1
    decoder_overhead: float = 0.08
    eyeriss_pe_ctrl_um2: float = 900.0
    eyeriss_spad_bits: int = 4384  # ~0.5 kB spads per PE (Eyeriss JSSC'17)
    eyeriss_glb_kbytes: int = 108


AREA_45NM = AreaModel()


def daism_area_mm2(
    banks: BankConfig,
    variant: Variant = Variant.PC3_TR,
    dtype: str = "bfloat16",
    area: AreaModel = AREA_45NM,
) -> float:
    epr = banks.elements_per_row(dtype, Variant(variant).truncated)
    sram = banks.num_banks * banks.bits * area.sram_um2_per_bit
    sram *= 1.0 + area.decoder_overhead  # multi-WL decoder + wider bus
    accum = banks.num_banks * epr * area.accum_um2
    rf = banks.num_banks * 1024 * 16 * area.rf_um2_per_bit  # 2 kB RF per bank
    return (sram + accum + rf) / 1e6


def eyeriss_area_mm2(num_pes: int = 168, dtype: str = "bfloat16",
                     area: AreaModel = AREA_45NM) -> float:
    pe = (area.mult_bf16_um2 + area.accum_um2 + area.eyeriss_pe_ctrl_um2
          + area.eyeriss_spad_bits * area.rf_um2_per_bit)
    glb = area.eyeriss_glb_kbytes * 1024 * 8 * area.sram_um2_per_bit
    return (num_pes * pe + glb) / 1e6


# ---------------------------------------------------------------------------
# Layer energy (ties Fig 7's per-mult numbers to Fig 9's architecture run)
# ---------------------------------------------------------------------------

def daism_layer_energy_uj(
    layer: ConvLayer,
    banks: BankConfig,
    variant: Variant = Variant.PC3_TR,
    dtype: str = "bfloat16",
) -> float:
    per = E.total(E.daism_energy_per_mult(
        variant, dtype, bank_kb=banks.bank_kbytes, bus_bits=banks.bus_bits))
    per += E.exponent_handling_energy(dtype)
    return per * layer.macs / 1e6


def eyeriss_layer_energy_uj(layer: ConvLayer, dtype: str = "bfloat16") -> float:
    per = E.total(E.eyeriss_energy_per_mult(dtype, truncated=True))
    per += E.exponent_handling_energy(dtype)
    return per * layer.macs / 1e6
