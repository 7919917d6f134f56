"""The DAISM approximate product and GEMM, frozen in plain torch.

A copy of the multiplier family of the paper (Table 1) for bfloat16
operands, written once for the benchmark and never imported from the
program. ``w`` is the multiplicand (the weight, stored in SRAM) and ``x``
the multiplier (the input, driving the wordlines): only FLA is symmetric.

* :func:`approx_mul_to_f32` is the elementwise product: signs XOR'd,
  exponents added exactly, the 8-bit mantissas (implicit 1 made explicit)
  multiplied by the variant's wired-OR read, renormalised by one top-bit
  test, subnormal inputs and results flushed to zero, overflow to inf.
* :func:`product_table` tabulates that product for every pair of 7-bit
  fractions: ``T[fw, fx]`` is the product of ``1.fw`` and ``1.fx``, a
  value in [1, 4) with at most 8 significant bits.
* :func:`matmul` is the GEMM ``sum_k approx(x[m, k] * w[k, n])`` with f32
  accumulation, at the widths the benchmark runs. It splits the sum by the
  fraction ``j`` of one operand: ``sum_j X_j @ W_j``, where ``W_j`` keeps
  the entries of ``w`` whose fraction is ``j`` as ``+-2**e`` and ``X_j``
  holds ``+-2**e * T[j, fx]``. Every entry of either factor has at most 8
  significant bits, so each product is exact in the bf16 tensor-core GEMM
  and only the f32 order of the sum differs from the kernel's.

``lower=True`` is the control: both operands are rounded to float8 e4m3
(per-tensor scale, the step a cheaper GEMM would take) before the product.
"""
from __future__ import annotations

import functools

import torch

BIAS = 127
VARIANTS = ("exact", "fla", "hla", "pc2", "pc3", "pc2_tr", "pc3_tr")
FP8_MAX = 448.0


def _fields(x: torch.Tensor):
    """bf16 -> (sign, biased exponent, 8-bit mantissa with the implicit 1)
    as int32; a subnormal has mantissa 0."""
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    sign = bits >> 15
    exp = (bits >> 7) & 0xFF
    man = torch.where(exp > 0, (bits & 0x7F) | 0x80, torch.zeros_like(bits))
    return sign, exp, man


def _bit(b: torch.Tensor, i: int) -> torch.Tensor:
    return (b >> i) & 1


def _or_lines(a: torch.Tensor, b: torch.Tensor, shifts) -> torch.Tensor:
    acc = torch.zeros_like(a)
    for i in shifts:
        acc = acc | torch.where(_bit(b, i) == 1, a << i, 0)
    return acc


def mantissa_product(mw: torch.Tensor, mx: torch.Tensor,
                     variant: str) -> torch.Tensor:
    """The 16-bit approximate product of two 8-bit mantissas whose top bit
    is set (float mode: the ``A`` line is always active)."""
    base = variant.replace("_tr", "")
    if base == "exact":
        out = mw * mx
    elif base == "fla":
        out = _or_lines(mw, mx, range(8))
    elif base == "hla":
        out = _or_lines(mw, mx, range(0, 8, 2)) + _or_lines(mw, mx,
                                                            range(1, 8, 2))
    elif base in ("pc2", "pc3"):
        k = 2 if base == "pc2" else 3
        head = _bit(mx, 7) | 1
        for j in range(1, k):
            head = 2 * head + _bit(mx, 7 - j)
        out = ((mw * head) << (8 - k)) | _or_lines(mw, mx, range(0, 8 - k))
    else:
        raise ValueError(f"unknown variant {variant!r}")
    if variant.endswith("_tr"):
        out = out & (0xFF << 8)
    return out


def approx_mul_to_f32(x: torch.Tensor, w: torch.Tensor,
                      variant: str) -> torch.Tensor:
    """Elementwise approximate product of broadcastable bf16 ``x``
    (multiplier) and ``w`` (multiplicand), as f32 bits."""
    if variant == "exact":
        return x.float() * w.float()
    sx, ex, mx = _fields(x)
    sw, ew, mw = _fields(w)
    sx, ex, mx, sw, ew, mw = torch.broadcast_tensors(sx, ex, mx, sw, ew, mw)
    prod = mantissa_product(mw, mx, variant)
    top = (prod >> 15) & 1
    man = torch.where(top == 1, prod >> 8, prod >> 7) & 0xFF
    sign = sx ^ sw
    exp = ex + ew - BIAS + top
    zero = (mx == 0) | (mw == 0) | (man == 0) | (exp <= 0)
    inf = exp >= 255
    s = sign << 31
    bits = s | (exp.clamp(0, 254) << 23) | ((man << 16) & 0x7FFFFF)
    bits = torch.where(zero, s, bits)
    bits = torch.where(inf & ~zero, s | 0x7F800000, bits)
    return bits.view(torch.float32)


@functools.lru_cache(maxsize=None)
def _table_cpu(variant: str) -> torch.Tensor:
    frac = torch.arange(128, dtype=torch.int32)
    one = ((BIAS << 7) | frac).to(torch.int16).view(torch.bfloat16)  # 1.f
    return approx_mul_to_f32(one[None, :], one[:, None], variant)  # [fw, fx]


def product_table(variant: str, device) -> torch.Tensor:
    """``T[fw, fx]``: the approximate product of ``1.fw`` (multiplicand)
    and ``1.fx`` (multiplier), f32 (128, 128) on ``device``."""
    return _table_cpu(variant).to(device)


def to_lower(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    bf16: the control's precision."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (x.float() * scale).to(torch.float8_e4m3fn)
    return (q.float() / scale).to(torch.bfloat16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with f32 accumulation and output: the
    tensor cores on the card (bf16 products are exact in f32), f32 on the
    CPU. Leading batch dims are allowed."""
    if a.device.type == "cuda":
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
        out = torch.bmm(a, b, out_dtype=torch.float32)
        return out.reshape(*lead, *out.shape[-2:])
    return a.float() @ b.float()


def _split(t: torch.Tensor):
    """(``+-2**(e-127)`` in bf16, 0 where ``t`` is 0 or subnormal; the
    7-bit fraction as int64)."""
    s, e, m = _fields(t)
    bits = (s << 15) | (e << 7)
    bits = torch.where(m == 0, torch.zeros_like(bits), bits)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(torch.int16).view(torch.bfloat16), (m & 0x7F).long()


def matmul(x: torch.Tensor, w: torch.Tensor, variant: str, *,
           lower: bool = False) -> torch.Tensor:
    """``sum_k approx(x[..., m, k] * w[..., k, n])`` in f32 (leading dims
    broadcast). ``x`` and ``w`` are bf16; ``lower`` rounds both to the
    control's precision first."""
    if lower:
        x, w = to_lower(x), to_lower(w)
    if variant == "exact":
        return _mm_f32(x, w)
    table = product_table(variant, x.device)
    px, fx = _split(x)
    pw, fw = _split(w)
    out = None
    if x.numel() <= w.numel():
        # gather the small operand, mask the large one
        for j in range(128):
            wj = torch.where(fw == j, pw, 0)
            xj = (px.float() * table[j][fx]).to(torch.bfloat16)
            part = _mm_f32(xj, wj)
            out = part if out is None else out.add_(part)
    else:
        for j in range(128):
            xj = torch.where(fx == j, px, 0)
            wj = (pw.float() * table[:, j][fw]).to(torch.bfloat16)
            part = _mm_f32(xj, wj)
            out = part if out is None else out.add_(part)
    return out
