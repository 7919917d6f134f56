// DAISM approximate-product primitives as __device__ functions.
//
// The CUDA counterpart of repro/kernels/approx_product.py (the Pallas
// kernels' shared primitives) and of its plain-torch twin
// repro_torch/kernels/approx_product.py. Every per-element product is
// bit-identical to repro_torch/core/floatmul.py::approx_mul_to_f32 for
// bfloat16 operands:
//
//   * the bf16 operand splits into sign, biased exponent and the 8-bit
//     mantissa with its hidden 1 (subnormals flush to a zero mantissa);
//   * the 8-bit mantissa product is the paper's Table-1 wired-OR read in
//     float mode (the multiplier's MSB is always set): FLA ORs mw << i for
//     every set bit i of mx; HLA adds the even-line OR and the odd-line OR;
//     PC2/PC3 add the pre-computed head line (mw * head weight, shifted) to
//     the OR of the low lines; _TR keeps the top 8 of the 16 bits;
//   * the product normalizes on its top bit, the exponents add (minus the
//     bias), a zero mantissa or exponent <= 0 gives a signed zero, and an
//     exponent >= 255 saturates to a signed inf.
//
// Operand order matters: x (the input, the GEMM's `a`) is the multiplier
// that drives the lines; w (the weight) is the multiplicand being shifted.
//
// A zero operand (mantissa 0) is folded into its exponent: it is stored as
// kZeroExp, which drives every product it takes part in to exponent <= 0,
// so the product is the signed zero the reference gives for
// (mx == 0) | (mw == 0).
#pragma once

#include <cstdint>

namespace daism {

enum Variant : int {
  kExact = 0,
  kFla = 1,
  kHla = 2,
  kPc2 = 3,
  kPc3 = 4,
  kPc2Tr = 5,
  kPc3Tr = 6,
};

constexpr int kBias = 127;
constexpr int kZeroExp = -1024;

__host__ __device__ constexpr int head_lines(int v) {
  return (v == kPc2 || v == kPc2Tr) ? 2 : (v == kPc3 || v == kPc3Tr) ? 3 : 0;
}

__host__ __device__ constexpr bool truncated(int v) {
  return v == kPc2Tr || v == kPc3Tr;
}

// The multiplier (input) operand, decomposed once per tile load. `lines`
// holds the mantissa bits that drive OR lines (the low lines only, for
// PC2/PC3), `head` the pre-computed head line's weight (PC2/PC3), `exp` the
// unbiased exponent (kZeroExp for a zero mantissa), `sign` the f32 sign bit.
struct XFields {
  int lines;
  int head;
  int exp;
  uint32_t sign;
};

// The multiplicand (weight) operand: mantissa with its hidden 1, biased
// exponent (kZeroExp for a zero mantissa), f32 sign bit.
struct WFields {
  int man;
  int exp;
  uint32_t sign;
};

__device__ __forceinline__ void split_bf16(uint16_t bits, uint32_t& sign,
                                           int& exp, int& man) {
  const int b = bits;
  sign = static_cast<uint32_t>(b >> 15) << 31;
  exp = (b >> 7) & 0xFF;
  man = exp > 0 ? ((b & 0x7F) | 0x80) : 0;
}

template <int V>
__device__ __forceinline__ XFields decompose_x(uint16_t bits) {
  XFields f;
  int exp, man;
  split_bf16(bits, f.sign, exp, man);
  f.exp = man ? exp - kBias : kZeroExp;
  constexpr int k = head_lines(V);
  if constexpr (k == 0) {
    f.lines = man;
    f.head = 0;
  } else {
    // float mode: the A line is always active, so the head weight's top
    // bit is 1; the next k-1 mantissa bits complete it
    int head = 1;
#pragma unroll
    for (int j = 1; j < k; ++j) head = 2 * head + ((man >> (7 - j)) & 1);
    f.head = head;
    f.lines = man & ((1 << (8 - k)) - 1);
  }
  return f;
}

__device__ __forceinline__ WFields decompose_w(uint16_t bits) {
  WFields f;
  int exp, man;
  split_bf16(bits, f.sign, exp, man);
  f.man = man;
  f.exp = man ? exp : kZeroExp;
  return f;
}

// OR of (mw << i) over the set bits i of `lines` in [lo, hi), step `step`.
template <int lo, int hi, int step>
__device__ __forceinline__ int or_lines(int mw, int lines) {
  int out = 0;
#pragma unroll
  for (int i = lo; i < hi; i += step) out |= (mw << i) & -((lines >> i) & 1);
  return out;
}

// The 16-bit approximate mantissa product (paper Table 1, float mode).
template <int V>
__device__ __forceinline__ int mantissa_product(int mw, const XFields& x) {
  int out;
  if constexpr (V == kFla) {
    out = or_lines<0, 8, 1>(mw, x.lines);
  } else if constexpr (V == kHla) {
    out = or_lines<0, 8, 2>(mw, x.lines) + or_lines<1, 8, 2>(mw, x.lines);
  } else {
    constexpr int k = head_lines(V);
    out = ((mw * x.head) << (8 - k)) | or_lines<0, 8 - k, 1>(mw, x.lines);
  }
  if constexpr (truncated(V)) out &= 0xFF00;
  return out;
}

// Normalize a 16-bit mantissa product and build the f32 bits.
__device__ __forceinline__ float compose_product(int prod, int exp_sum,
                                                 uint32_t sign) {
  const int top = (prod >> 15) & 1;
  const int man = (prod >> (7 + top)) & 0xFF;
  const int e = exp_sum + top;
  uint32_t bits;
  if (man == 0 || e <= 0) {
    bits = sign;
  } else if (e >= 255) {
    bits = sign | 0x7F800000u;
  } else {
    bits = sign | (static_cast<uint32_t>(e) << 23) |
           ((static_cast<uint32_t>(man) << 16) & 0x7FFFFFu);
  }
  return __uint_as_float(bits);
}

// The product as the reference spells it: the definition that
// approx_mac_lean, which the kernels run, is checked against.
template <int V>
__device__ __forceinline__ float approx_product(const XFields& x,
                                                const WFields& w) {
  return compose_product(mantissa_product<V>(w.man, x), x.exp + w.exp,
                         x.sign ^ w.sign);
}

// acc + approx_product<V>(x, w) in fewer operations, with half of them
// multiplies: the kernels' multiply-accumulate, the same bits for every
// pair of bf16 operands and every accumulator a kernel can hold (held
// against approx_product over all 2**32 pairs on the card by
// approx_product_check). An SM issues four warp instructions a clock but
// runs logic, shifts, compares and selects on its ALU pipe at half that
// rate, while IMAD and FADD go to the FMA pipe: so each line is a multiply
// of the multiplicand by the line's bit in place (lines & 2**i, made once
// per multiplier and hoisted over the multiplicands it meets), the lines
// are ORed three at a time, and the normalizing shift is a multiply. It
// rests on five facts:
//   * the mantissa product is below 2**16 for every variant (FLA's largest
//     line is mw << 7 < 2**15, so FLA's top bit is always 0; HLA's two ORs
//     sum below 2**16; the head line (mw head) << (8 - k) < 2**16), so its
//     top bit is prod >> 15;
//   * it is at least 2**14 unless an operand is zero (the multiplier's top
//     line or head weight is always set), and a zero operand carries
//     kZeroExp, so a zero mantissa never needs its own test: e <= 0;
//   * ((prod >> (7 + top)) & 0xFF) << 16 & 0x7FFFFF is
//     (prod << (9 - top)) & 0x7F0000, and prod << (9 - top) is
//     prod * (512 - 256 top);
//   * the truncation (_TR) clears the bits below 8, of which only bit 7
//     reaches the fraction, and only when top is 0: it is a mask on the
//     shifted product, 0x7E0000 + (top << 16). So the lines below bit 8 need
//     not be cleared: line 0 (mw < 2**8) drops out, and line 1 of a nonzero
//     mw (hidden bit 7 set) adds exactly 0x100 above bit 7;
//   * a product with e <= 0 is a signed zero, and adding it leaves every
//     accumulator but -0 as it is; the kernels' accumulators start at +0
//     and an f32 sum is -0 only when both terms are, so the add is skipped
//     (predicated) instead of the zero being selected.
// Counted with the multiplier's terms hoisted, PC3_TR takes 17 operations
// (5 multiplies, 2 ORs of three, 10 to compose the f32 bits and add them),
// 9 of them on the FMA pipe; chip_smoke.py's OPS_PER_MAC holds every
// variant's count.
template <int lo, int hi, int step>
__device__ __forceinline__ int or_lines_lean(int mw, int lines, int out) {
#pragma unroll
  for (int i = lo; i < hi; i += step) out |= mw * (lines & (1 << i));
  return out;
}

template <int V>
__device__ __forceinline__ int mantissa_product_lean(int mw, const XFields& x) {
  if constexpr (V == kFla) {
    return or_lines_lean<0, 8, 1>(mw, x.lines, 0);
  } else if constexpr (V == kHla) {
    return or_lines_lean<0, 8, 2>(mw, x.lines, 0) +
           or_lines_lean<1, 8, 2>(mw, x.lines, 0);
  } else {
    constexpr int k = head_lines(V);
    const int head = mw * (x.head << (8 - k));
    if constexpr (!truncated(V)) {
      return or_lines_lean<0, 8 - k, 1>(mw, x.lines, head);
    } else {
      return or_lines_lean<2, 8 - k, 1>(mw, x.lines,
                                        head | ((x.lines & 2) << 7));
    }
  }
}

template <int V>
__device__ __forceinline__ float approx_mac_lean(float acc, const XFields& x,
                                                 const WFields& w) {
  const int prod = mantissa_product_lean<V>(w.man, x);
  const int top = V == kFla ? 0 : prod >> 15;
  const uint32_t shifted =
      static_cast<uint32_t>(prod) * static_cast<uint32_t>(512 - 256 * top);
  const uint32_t mask =
      truncated(V) ? 0x7E0000u + (static_cast<uint32_t>(top) << 16) : 0x7F0000u;
  const int e = x.exp + w.exp + top;
  // e >= 255 gives a signed inf: (e << 23) is then at least 0x7F800000
  // unsigned (e <= 382), and the min drops the mantissa
  const uint32_t bits =
      min((static_cast<uint32_t>(e) << 23) | (shifted & mask), 0x7F800000u);
  return e > 0 ? acc + __uint_as_float((x.sign ^ w.sign) | bits) : acc;
}

}  // namespace daism
