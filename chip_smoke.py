#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # on a machine with one NVIDIA H100

Builds the CUDA kernels from the sources in ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the port's main
paths at TinyLlama-1.1B's published width (random bf16 weights from a seed):
the paged server through two policy tiers, the full-sequence
``prefill_step`` with and without the flash-attention kernel, and the
``train_step`` with straight-through and approximate backward, and prints
the kernels' times beside their bounds. Phases:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc of every kernel source, all started together, timed;
3. kernels  — daism_matmul: (a) K = 1 outer products over every pair of
              normalized bf16 mantissas with mixed signs and exponents
              (underflow and overflow included): bit-identical to the plain
              version for the six approximate variants; (b) the serving
              path's GEMM shapes (decode M = 4, prefill M = 128) and ragged
              edges past one M tile, for all seven variants within
              gemm_rtol(K) * (|a| @ |w|) + 1e-6; (c) an f32 operand raises
              ValueError. flash_attention: (d) exact and the six approximate
              variants, D in {16, 32, 64, 128}, causal and not, GQA (H=32,
              KH=4), MHA and MQA, a ragged (B=2, Sq=100, Skv=72, H=4, KH=2)
              and f32 exact inputs, against the plain version (same KV tiles
              in the same order): exact within 2e-3 + 2e-2 |plain| (the JAX
              suite's), approximate within 2**-6 |plain| + 1e-3 (see
              FLASH_APPROX_TOL); (e) causally masked KV tiles are skipped
              (poisoned keys past them change nothing); (f) one KV tile
              against the reference's semantics oracle (DAISM products of
              kernels/ref.py and a plain softmax), 2e-2 (the JAX suite's);
4. serve    — the engine serves 8 requests through the ``free`` and
              ``paid`` tiers; every request completes at its length, both
              groups run, the prefix cache hits, the kernel's launch count
              equals the count the steps imply, and a small input's logits
              through the kernel agree with the plain (jnp-backend) path;
5. prefill  — ``prefill_step`` at 22 layers, B=1, S=2048 under three
              policies (approximate flash, exact flash, jnp attention, all
              with approximate GEMMs on the kernel) and an exact-GEMM pair;
              flash launches 22 and the GEMM kernel its sites per forward;
              exact flash agrees with jnp attention (bounds printed);
6. train    — ``train_step`` at 22 layers, B=2, S=256: 3 steps with the
              straight-through backward, 1 with the approximate backward on
              the kernel; finite loss and grad norm, the kernel's launches
              per step as the sites imply; a ``:flash`` policy raises;
7. numbers  — kernel / plain / library times (CUDA events) and the bound
              at each shape, the serve report, prefill and step times. The
              outputs of the timed calls are held against each other at the
              main paths' own shapes: daism_matmul at the prefill GEMMs
              (M = 2048) and every train-step GEMM (forward and approximate
              backward, K up to 32000) within the (b) bound; flash at
              TinyLlama's heads, S = 2048, for all seven variants within the
              (d) bounds, with controls that must break the approximate
              bound (the exact and FLA kernels against the PC3_TR plain).

Every check raises on failure and nothing is caught (checks 3c and 6 expect
their errors), so any failure exits non-zero before the final line. TF32 is
off for every f32 matmul here.
The last two lines are the JSON kernel record and the result line.
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, as tabulated in the repo's measurement
# notes): HBM 3.35 TB/s; bf16 tensor cores 989 TFLOP/s (the least time an
# exact bf16 GEMM could take). The INT32 rate is derived from the same
# sheet's FP32 rate (67 TFLOP/s = 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz):
# each SM has 64 INT32 lanes, so 132 x 64 x 1.98e9 integer ops/s.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Integer operations per approximate MAC, counted from the chain in
# src/repro_torch/csrc/approx_product.cuh with operand-only terms hoisted:
# the line selects (one AND/OR each: 8 for FLA and HLA, 6 for PC2, 5 for
# PC3), HLA's add, the head line's multiply (PC2/PC3), the truncation mask
# (_TR), and 13 for normalization, exponent add, sign and f32 composition.
OPS_PER_MAC = {"fla": 8 + 13, "hla": 8 + 1 + 13, "pc2": 1 + 6 + 13,
               "pc3": 1 + 5 + 13, "pc2_tr": 1 + 6 + 1 + 13,
               "pc3_tr": 1 + 5 + 1 + 13}

KN_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
             (2048, 32000)]
# M rows of one GEMM: 4 at decode (num_slots=4), 128 at a prefill step
# (num_slots x prefill_chunk = 4 x 32, two M tiles), 64 one full tile
M_SHAPES = [4, 64, 128]
RAGGED_SHAPES = [(5, 70, 33), (130, 300, 130)]
# the train step's GEMMs at B x S = 512 tokens, (M, K, N): the wi/wg
# forward, its two approximate-backward GEMMs (da = g @ w^T, dw = a^T @ g),
# and the lm_head's
TRAIN_GEMM_SHAPES = [(512, 2048, 5632), (512, 5632, 2048), (2048, 512, 5632),
                     (512, 2048, 32000), (512, 32000, 2048),
                     (2048, 512, 32000)]
# the prefill step's GEMMs at B x S = 2048 tokens
PREFILL_GEMM_SHAPES = [(2048, k, n) for k, n in KN_SHAPES]
REPRESENTATIVE = ("pc3_tr", 4, 2048, 5632)  # decode-time wi/wg GEMM
TIERS = (("free", "*=pc3_tr:pallas"),
         ("paid", "*/attn/*=exact,*=pc3_tr:pallas"))

# flash attention checks on the card, (B, Sq, Skv, H, KH, D), each causal
# and not: small enough for the plain version (B*H <= 32, S <= 512)
FLASH_CHECK_SHAPES = [
    (1, 256, 256, 32, 4, 64),   # GQA at TinyLlama's heads; two KV tiles
    (2, 512, 512, 4, 4, 128),   # MHA, D = 128, four KV tiles
    (2, 384, 384, 4, 1, 32),    # MQA, three KV tiles
    (1, 200, 200, 8, 2, 16),    # D = 16, ragged
]
FLASH_RAGGED = (2, 100, 72, 4, 2, 64)      # non-causal, both lengths ragged
FLASH_TIMED = (1, 2048, 2048, 32, 4, 64)   # TinyLlama's heads at S = 2048
FLASH_EXACT_TOL = (2e-3, 2e-2)             # atol, rtol (the JAX suite's)
# kernel vs plain, approximate, any number of KV tiles: (atol, rtol). Both
# run the same KV tiles in the same order with the same rounding points
# (RNE bf16 p, expf); only the f32 summation order inside the QK dot
# products, the row sums and the PV sums differs. That leaves the outputs
# one bf16 rounding apart (2**-7 |plain| at most; two ulps allowed), except
# where a score's last f32 bit rounds a p to the neighbouring bf16: the
# approximate PV product of that p can then jump by up to 2**-3 of itself,
# which moves the output by 2**-3 p |v| / l. 1e-3 absolute covers that;
# phases 3 (d) and 7 print the largest excess over the two ulps. A wrong
# product or p rounding breaks the bound: phase 7's controls (the exact and
# FLA kernels against the PC3_TR plain version) must exceed it.
FLASH_APPROX_TOL = (1e-3, 2.0**-6)
# one KV tile against the semantics oracle (another arithmetic for the
# softmax and the divide): the JAX suite's single-tile bound
FLASH_ORACLE_ATOL = 2e-2

PREFILL_SEQ = 2048   # TinyLlama's published context
PREFILL_POLICIES = (
    ("flash pc3_tr", "*/attn/kernel=pc3_tr:flash,*=pc3_tr:pallas"),
    ("flash exact", "*/attn/kernel=exact:flash,*=pc3_tr:pallas"),
    ("jnp attention", "*=pc3_tr:pallas"),
    ("flash exact, exact GEMMs", "*/attn/kernel=exact:flash,*=exact"),
    ("jnp attention, exact GEMMs", "*=exact"),
)
# bounds on max |exact flash - jnp attention| / max |logit| at S = 2048,
# 22 layers, bf16. Both attentions are exact in f32 and differ only in
# summation order, which rounds some bf16 attention outputs one ulp apart.
# With exact GEMMs that stays a rounding difference: the serve phase's
# bf16 bound 3e-2 (measured 0.0184). With approximate GEMMs the products
# jump at carry boundaries, so such 1-ulp inputs move a product by up to
# ~2**-3 of itself, and 22 layers compound it (the JAX model's own response
# to a 1-ulp change is ~7% of max|logit| at 2 layers): ~1.5x the measured
# 0.1225.
# Greedy tokens must agree on every row whose top-2 gap exceeds the
# deviation.
PREFILL_EXACT_REL = 3e-2
PREFILL_APPROX_REL = 0.2
TRAIN_BATCH, TRAIN_SEQ = 2, 256
# the GEMM kernel against its plain version: |kernel - plain| <=
# gemm_rtol(K) * (|a| @ |w|) + 1e-6. Both add the same f32 products in
# another order; the error of an f32 sum of K terms is at most K * 2**-24
# times the sum of their magnitudes (3.4e-4 at K = 5632, hence 4e-4 there),
# and it grows linearly in K: 2.27e-3 at the lm_head backward's K = 32000.
GEMM_RTOL_K, GEMM_RTOL = 5632, 4e-4


def gemm_rtol(k: int) -> float:
    return GEMM_RTOL * max(1.0, k / GEMM_RTOL_K)

KERNELS = ("daism_matmul", "flash_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1):
    """(mean time of ``fn`` over ``reps`` calls by CUDA events, the last
    call's result)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(variant: str, m: int, k: int, n: int):
    """(bound_ms, bound_by, ops) for one (M,K) @ (K,N) GEMM: each input read
    once, the f32 output written once, against the operations it does."""
    nbytes = 2 * m * k + 2 * k * n + 4 * m * n
    if variant == "exact":
        ops = 2 * m * k * n
        op_s = ops / BF16_TENSOR_FLOPS
    else:
        ops = OPS_PER_MAC[variant] * m * k * n
        op_s = ops / INT32_OPS_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations", ops
    return byte_s * 1e3, "bytes", ops


def flash_bound(variant: str, b: int, s: int, h: int, kh: int, d: int):
    """(bound_ms, bound_by, ops) for causal (S, S) flash attention over
    B x H heads: q, k, v and o read or written once (bf16), against the
    work the inputs need, S (S + 1) / 2 score pairs a head with 2 D
    products each (4 D flops exact, on the bf16 tensor cores)."""
    pairs = b * h * s * (s + 1) // 2
    nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kh * d)
    if variant == "exact":
        ops = 4 * pairs * d
        op_s = ops / BF16_TENSOR_FLOPS
    else:
        ops = OPS_PER_MAC[variant] * 2 * pairs * d
        op_s = ops / INT32_OPS_PER_S
    byte_s = nbytes / HBM_BYTES_PER_S
    if op_s >= byte_s:
        return op_s * 1e3, "operations", ops
    return byte_s * 1e3, "bytes", ops


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def outer_product_operands(gen, device):
    """(M, 1) and (1, N) bf16 operands covering all 128 normalized mantissas
    at several exponents each (their sums underflow and overflow), random
    signs, plus zeros and subnormals."""
    import torch

    exps = torch.tensor([1, 40, 100, 127, 160, 220, 254], device=device)
    frac = torch.arange(128, device=device)
    bits = ((exps[:, None] << 7) | frac[None, :]).reshape(-1)
    bits = torch.cat([bits, torch.tensor([0, 1, 0x7F, 0x40], device=device)])
    sign = torch.randint(0, 2, bits.shape, generator=gen, device=device)
    bits = bits | (sign << 15)
    b16 = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    x = b16.view(torch.bfloat16)
    perm = torch.randperm(x.numel(), generator=gen, device=device)
    return x[:, None].contiguous(), x[perm][None, :].contiguous()


def check_kernel(device):
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(0)
    a1, w1 = outer_product_operands(gen, device)
    for v in Variant:
        got = dm.daism_matmul_kernel(a1, w1, v)
        ref = dm.daism_matmul_plain(a1, w1, v)
        torch.cuda.synchronize()
        if v is Variant.EXACT:  # exact products; cuBLAS may flush subnormals
            ok = bool(((got == ref) | ((got - ref).abs() <= 2.0**-126)).all())
        else:
            ok = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        if not ok:
            bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
            raise SystemExit(f"K=1 products of {v.value}: {bad} of "
                             f"{got.numel()} differ from the plain version")
    log(f"  (a) K=1 products: {a1.shape[0]} x {w1.shape[1]} pairs; the six "
        "approximate variants bit-identical to the plain version, EXACT "
        "within 2**-126")

    max_err = 0.0
    shapes = [(m, k, n) for m in M_SHAPES for k, n in KN_SHAPES]
    shapes += RAGGED_SHAPES
    for m, k, n in shapes:
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        for v in Variant:
            got = dm.daism_matmul_kernel(a, w, v)
            ref = dm.daism_matmul_plain(a, w, v)
            torch.cuda.synchronize()
            err, _ = gemm_held(got, ref, a, w, f"{v.value} ({m},{k},{n})")
            max_err = max(max_err, err)
    log(f"  (b) {len(shapes)} shapes x {len(Variant)} variants within "
        f"gemm_rtol(K)*(|a|@|w|)+1e-6; max |kernel - plain| = {max_err:.6g}")

    f32 = torch.zeros((4, 8), device=device)
    try:
        dm.daism_matmul_kernel(f32, f32.t().contiguous(), Variant.PC3_TR)
    except ValueError:
        log("  (c) f32 operands raise ValueError")
    else:
        raise SystemExit("f32 operands were accepted by the kernel wrapper")
    return max_err


def gemm_held(got, ref, a, w, what):
    """Hold a GEMM kernel output against its plain version within
    gemm_rtol(K) * (|a| @ |w|) + 1e-6; returns (max |kernel - plain|, max
    of that error over |a| @ |w|)."""
    import torch

    k = a.shape[1]
    scale = a.double().abs() @ w.double().abs()
    err = (got.double() - ref.double()).abs()
    excess = (err - (gemm_rtol(k) * scale + 1e-6)).max().item()
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise SystemExit(f"{what}: |kernel - plain| exceeds "
                         f"{gemm_rtol(k):.3g}*(|a|@|w|)+1e-6 by {excess:.3g}")
    return err.max().item(), (err / scale.clamp_min(1e-30)).max().item()


def _bhsd_inputs(gen, device, b, sq, skv, h, kh, d, dtype=None):
    import torch

    shapes = ((b, sq, h, d), (b, skv, kh, d), (b, skv, kh, d))
    return [torch.randn(sh, generator=gen, device=device).to(
        dtype or torch.bfloat16) for sh in shapes]


def flash_excess(got, ref, variant, oracle=False):
    """(max |got - ref|, its largest excess over the bound, the bound's
    text): the exact bound, the approximate kernel-vs-plain bound, or the
    single-tile oracle bound."""
    err = (got.float() - ref.float()).abs()
    if oracle:
        atol, rtol = FLASH_ORACLE_ATOL, 0.0
    else:
        atol, rtol = FLASH_EXACT_TOL if variant is None else FLASH_APPROX_TOL
    excess = (err - (atol + rtol * ref.float().abs())).max().item()
    return err.max().item(), excess, f"{atol:g} + {rtol:.4g} |ref|"


def _flash_held(got, ref, variant, what, errs, oracle=False):
    """Hold a kernel output against its reference; record the largest
    error under ``errs['exact' | 'approx']`` and, for approximate variants,
    the largest excess over two bf16 ulps (2**-6 |ref|) under
    ``errs['approx_over_2ulp']``."""
    import torch

    err, excess, bound = flash_excess(got, ref, variant, oracle)
    if not bool(torch.isfinite(got).all()) or excess > 0:
        raise SystemExit(f"flash {what}: |kernel - reference| exceeds {bound} "
                         f"by {excess:.3g} (or is not finite)")
    key = "oracle" if oracle else "exact" if variant is None else "approx"
    errs[key] = max(errs[key], err)
    if variant is not None and not oracle:
        over = ((got.float() - ref.float()).abs()
                - 2.0**-6 * ref.float().abs()).max().item()
        errs["approx_over_2ulp"] = max(errs["approx_over_2ulp"], over)


def flash_semantics_oracle(q, k, v, variant, causal):
    """One KV tile of the reference kernel's arithmetic, rebuilt in torch
    (tests/test_flash_attention.py's ``_flash_semantics_oracle``): DAISM QK
    products of kernels/ref.py, scale, mask, the unnormalized exp weights
    cast to bf16, DAISM PV products, an exact divide by the row sum."""
    import numpy as np
    import torch

    from repro_torch.kernels.ref import daism_matmul_ref

    bh, s, d = q.shape
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    outs = []
    for i in range(bh):
        sm = daism_matmul_ref(q[i], k[i].t(), variant) * float(1.0 / np.sqrt(d))
        if causal:
            sm = torch.where(mask, sm, -1e30)
        p = torch.exp(sm - sm.amax(-1, keepdim=True))
        if causal:
            p = torch.where(mask, p, 0.0)
        pv = daism_matmul_ref(p.to(torch.bfloat16), v[i], variant)
        outs.append(pv / p.sum(-1, keepdim=True))
    return torch.stack(outs)


def check_flash(device):
    """Phase 3 (d)-(f); returns the largest |kernel - plain| seen for exact
    and approximate variants, the largest approximate excess over two bf16
    ulps, and the largest |kernel - oracle|."""
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(3)
    variants = [None] + [v for v in Variant if v is not Variant.EXACT]
    errs = {"exact": 0.0, "approx": 0.0, "approx_over_2ulp": -1.0,
            "oracle": 0.0}
    n = 0
    for shape in FLASH_CHECK_SHAPES:
        q, k, v = _bhsd_inputs(gen, device, *shape)
        for causal in (True, False):
            for var in variants:
                got = fa.flash_attention_bhsd_kernel(q, k, v, causal=causal,
                                                     variant=var)
                ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal,
                                                    variant=var)
                torch.cuda.synchronize()
                _flash_held(got, ref, var, f"{shape} causal={causal} "
                            f"{var or 'exact'}", errs)
                n += 1
    q, k, v = _bhsd_inputs(gen, device, *FLASH_RAGGED)
    for var in variants:  # the dispatching entry point, as the model calls it
        got = fa.flash_attention_bhsd(q, k, v, causal=False, variant=var)
        ref = fa.flash_attention_bhsd_plain(q, k, v, causal=False, variant=var)
        torch.cuda.synchronize()
        if got.shape != q.shape:
            raise SystemExit(f"ragged flash output shaped {tuple(got.shape)}")
        _flash_held(got, ref, var, f"ragged {FLASH_RAGGED} {var or 'exact'}",
                    errs)
        n += 1
    q, k, v = _bhsd_inputs(gen, device, 1, 256, 256, 4, 2, 64, torch.float32)
    for causal in (True, False):
        got = fa.flash_attention_bhsd_kernel(q, k, v, causal=causal)
        ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _flash_held(got, ref, None, f"f32 causal={causal}", errs)
        n += 1
    log(f"  (d) flash_attention: {n} cases (7 variants x D in 16..128, causal "
        f"and not, GQA / MHA / MQA, ragged, f32) within the bounds; max "
        f"|kernel - plain| exact {errs['exact']:.4g} (bound "
        f"{FLASH_EXACT_TOL[0]:g} + {FLASH_EXACT_TOL[1]:g} |plain|), "
        f"approximate {errs['approx']:.4g} (bound {FLASH_APPROX_TOL[0]:g} + "
        f"2**-6 |plain|; largest excess over 2**-6 |plain| "
        f"{errs['approx_over_2ulp']:.4g})")

    # (e) causal S = 256: query rows 0..127 never see keys 128..255, whose
    # KV tile the kernel skips for them; poisoning those keys with NaN must
    # leave those rows bit-identical (and the plain version, which runs the
    # masked tile, agrees on them: checked in (d))
    q, k, v = _bhsd_inputs(gen, device, 1, 256, 256, 4, 2, 64)
    for var in (None, Variant.PC3_TR):
        clean = fa.flash_attention_bhsd_kernel(q, k, v, variant=var)
        kp, vp = k.clone(), v.clone()
        kp[:, 128:] = float("nan")
        vp[:, 128:] = float("nan")
        poisoned = fa.flash_attention_bhsd_kernel(q, kp, vp, variant=var)
        torch.cuda.synchronize()
        if not torch.equal(clean[:, :128], poisoned[:, :128]):
            raise SystemExit("flash: a causally masked KV tile changed rows "
                             "that never see it")
    log("  (e) causally masked KV tiles: keys poisoned with NaN past row 127 "
        "leave rows 0..127 bit-identical (exact and pc3_tr)")

    # (f) one KV tile against the reference's semantics oracle
    for var in (Variant.PC3_TR, Variant.FLA):
        for causal in (True, False):
            q, k, v = (t[0].transpose(0, 1).contiguous() for t in
                       _bhsd_inputs(gen, device, 1, 128, 128, 2, 2, 64))
            got = fa.flash_attention_kernel(q, k, v, causal=causal, variant=var)
            ref = flash_semantics_oracle(q, k, v, var, causal)
            torch.cuda.synchronize()
            _flash_held(got, ref, var, f"oracle {var.value} causal={causal}",
                        errs, oracle=True)
    log(f"  (f) one KV tile vs the semantics oracle (pc3_tr, fla; causal and "
        f"not): max |kernel - oracle| {errs['oracle']:.4g} <= "
        f"{FLASH_ORACLE_ATOL:g}")
    return errs


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve_requests(vocab: int):
    """8 requests over the two tiers, Poisson arrivals, ~32-token prompts
    and ~16 generated tokens; requests 5 and 6 repeat the prompts (and
    tiers) of requests 1 and 2, so the prefix cache must hit."""
    from repro_torch.serve import poisson_requests

    reqs = poisson_requests(8, vocab, rate=0.5, base_prompt=32, base_gen=16,
                            seed=0, tiers=[name for name, _ in TIERS])
    for dst, src in ((5, 1), (6, 2)):
        reqs[dst].prompt = list(reqs[src].prompt)
        reqs[dst].policy = reqs[src].policy
    return reqs


def approx_launches_per_step(model) -> int:
    """GEMM sites of one step that resolve to the kernel (an approximate
    config on the ``pallas`` backend), by the model's policy segments."""
    from repro_torch.core.config import Backend
    from repro_torch.models.transformer import decoder_block_sites
    from repro_torch.policy import OpKind

    cfg = model.cfg
    pol = cfg.approx_policy

    def on_kernel(path, kind):
        c = pol.resolve(path, kind)
        return not c.exact and c.backend is Backend.PALLAS

    n = 0
    for lo, hi in model.segments:
        per_layer = sum(on_kernel(p, k) for p, k in decoder_block_sites(cfg, lo)
                        if k is not OpKind.ATTN_QK)
        n += (hi - lo) * per_layer
    return n + on_kernel("decoder/lm_head", OpKind.LM_HEAD)


def serve(device, cfg):
    """Serve ``serve_requests`` with ``cfg`` through the two tiers and check
    the run; returns (report, kernel launches during the run)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.models.module import flatten
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    with torch.inference_mode():
        params = model.init(seed=0)
    _sync(device)
    n_params = sum(t.numel() for t in flatten(params).values())
    log(f"  tinyllama_1_1b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f}e9 bf16 "
        f"params drawn on the card in {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(num_slots=4, block_size=16, prefill_chunk=32,
                        max_seq=128, tiers=TIERS)
    engine = ServeEngine(model, params, ecfg, device=device)
    reqs = serve_requests(cfg.vocab)

    dm.launches = 0
    report = engine.run(reqs)
    _sync(device)
    launches = dm.launches

    for st in report.completed:
        if len(st.output) != st.request.max_new_tokens:
            raise SystemExit(f"request {st.request_id} produced "
                             f"{len(st.output)} of {st.request.max_new_tokens}")
    if len(report.completed) != len(reqs):
        raise SystemExit(f"{len(report.completed)} of {len(reqs)} completed")
    if report.policy_groups != 2:
        raise SystemExit(f"{report.policy_groups} policy groups ran, not 2")
    if report.prefix_hits < 1:
        raise SystemExit("the prefix cache never hit")
    per_step = {g.label: approx_launches_per_step(g.model)
                for g in engine.groups.values()}
    expected = sum(report.group_steps[label] * n
                   for label, n in per_step.items())
    log(f"  kernel sites per step {per_step}; steps {report.group_steps}")
    if launches != expected or launches == 0:
        raise SystemExit(f"daism_matmul launched {launches} times; the steps "
                         f"imply {expected}")
    log(f"  {len(report.completed)} requests completed at their lengths; "
        f"{report.policy_groups} groups; {report.prefix_hits} prefix-cache "
        f"hit(s); daism_matmul launches {launches} == {expected} implied")

    # logits of a small input: finite, and the kernel path agrees with the
    # plain jnp-backend path (same weights, first two layers, both on the
    # card); bf16 rounds at op boundaries, hence 3e-2 * max|ref|
    small = dataclasses.replace(cfg, n_layers=2)
    sparams = dict(params, blocks={
        s: {k: v[:2] for k, v in sub.items()}
        for s, sub in params["blocks"].items()})
    toks = torch.randint(0, cfg.vocab, (1, 8), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    with torch.inference_mode():
        got, _ = build_model(small.with_policy("*=pc3_tr:pallas"),
                             device=device).forward(sparams, {"tokens": toks})
        ref, _ = build_model(small.with_policy("*=pc3_tr"),
                             device=device).forward(sparams, {"tokens": toks})
    _sync(device)
    if not torch.isfinite(got).all() or got.shape != (1, 8, cfg.vocab):
        raise SystemExit(f"logits not finite or shaped {tuple(got.shape)}")
    dev = (got.float() - ref.float()).abs().max().item()
    lim = 3e-2 * ref.float().abs().max().item()
    if dev > lim:
        raise SystemExit(f"kernel-path logits differ from the plain path by "
                         f"{dev:.4g} > {lim:.4g}")
    log(f"  small input (2 layers, 8 tokens): logits finite, kernel path vs "
        f"plain path max |diff| {dev:.4g} <= {lim:.4g}")
    return report, launches


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _logit_agreement(got, ref):
    """(max |got - ref| / max |ref|, greedy-token agreement on every row,
    and on the rows whose top-2 gap exceeds the deviation)."""
    got, ref = got.float(), ref.float()
    dev = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > dev
    same = got.argmax(-1) == ref.argmax(-1)
    return (dev / ref.abs().max().item(), same.float().mean().item(),
            bool(same[clear].all()), int(clear.sum()))


# ---------------------------------------------------------------------------
# phase 5: prefill
# ---------------------------------------------------------------------------

def prefill(device, cfg):
    """``prefill_step`` at full width and ``cfg``'s depth, B=1, S=2048,
    under PREFILL_POLICIES; returns (results, flash launches, GEMM kernel
    launches) of the run."""
    import torch

    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import build_artifacts

    params = build_artifacts(cfg, device=device).init_params(0)
    tokens = next(lm_batches(cfg.vocab, 1, PREFILL_SEQ, seed=0))["tokens"]
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    arts = {label: build_artifacts(cfg.with_policy(spec), device=device)
            for label, spec in PREFILL_POLICIES}

    logits, results = {}, {}
    fa.launches = dm.launches = 0
    for label, spec in PREFILL_POLICIES:
        art = arts[label]
        f0, d0 = fa.launches, dm.launches
        t0 = time.perf_counter()
        out = art.prefill_step(params, batch)
        _sync(device)
        sec = time.perf_counter() - t0
        flash_n, gemm_n = fa.launches - f0, dm.launches - d0
        want_flash = cfg.n_layers if ":flash" in spec else 0
        want_gemm = approx_launches_per_step(art.model)
        if (flash_n, gemm_n) != (want_flash, want_gemm):
            raise SystemExit(f"prefill {label!r}: flash launched {flash_n} "
                             f"(expected {want_flash}), daism_matmul {gemm_n} "
                             f"(expected {want_gemm})")
        if out.shape != (1, PREFILL_SEQ, cfg.vocab) or \
                not bool(torch.isfinite(out).all()):
            raise SystemExit(f"prefill {label!r}: logits not finite or "
                             f"shaped {tuple(out.shape)}")
        logits[label] = out
        results[label] = dict(ms=sec * 1e3, tok_s=PREFILL_SEQ / sec,
                              flash=flash_n, gemm=gemm_n)
        log(f"  {label:27s} {sec * 1e3:9.1f} ms  {PREFILL_SEQ / sec:8.1f} "
            f"tok/s  launches: flash {flash_n}, daism_matmul {gemm_n}")
    flash_launches, gemm_launches = fa.launches, dm.launches

    for (a, b), lim in ((("flash exact, exact GEMMs",
                          "jnp attention, exact GEMMs"), PREFILL_EXACT_REL),
                        (("flash exact", "jnp attention"), PREFILL_APPROX_REL)):
        rel, agree, clear_ok, n_clear = _logit_agreement(logits[a], logits[b])
        results[f"{a} vs {b}"] = dict(rel=rel, agree=agree, n_clear=n_clear)
        log(f"  {a!r} vs {b!r}: max |diff| / max |ref| {rel:.4g} (bound "
            f"{lim:g}); greedy tokens agree on {agree * 100:.2f}% of rows, "
            f"on all {n_clear} rows whose top-2 gap exceeds the deviation: "
            f"{clear_ok}")
        if rel > lim or not clear_ok:
            raise SystemExit(f"prefill: {a!r} and {b!r} disagree beyond the "
                             "bound")
    del logits, params, arts
    _free(device)
    return results, flash_launches, gemm_launches


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

def train(device, cfg):
    """3 ``train_step``s (STE backward) and 1 with the approximate backward
    at full width, B=2, S=256; returns (step records, GEMM kernel
    launches of the run)."""
    import torch

    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.data import lm_batches
    from repro_torch.kernels import daism_matmul as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.policy import ApproxPolicy

    def arts(policy):
        return build_artifacts(cfg.with_policy(policy), device=device,
                               warmup=1, total_steps=100)

    ste = arts("*=pc3_tr:pallas")
    approx = arts(ApproxPolicy.uniform(DaismConfig(
        variant=Variant.PC3_TR, backend=Backend.PALLAS, backward="approx")))
    params = ste.init_params(0)
    opt = ste.init_opt(params)
    batches = lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)

    # the flash kernel has no backward (nor has the reference's): a train
    # step under a ':flash' policy raises and leaves params and state alone
    try:
        arts("*/attn/kernel=exact:flash,*=pc3_tr:pallas").train_step(
            params, opt, next(batches))
    except NotImplementedError as e:
        log(f"  a ':flash' train step raises NotImplementedError: {e}")
    else:
        raise SystemExit("a train step under a ':flash' policy did not raise")
    if int(opt.step) != 0:
        raise SystemExit("the refused step moved the optimizer")

    per_fwd = approx_launches_per_step(ste.model)
    plan = [("ste", ste, per_fwd)] * 3 + [("approx", approx, 3 * per_fwd)]
    steps = []
    torch.cuda.reset_peak_memory_stats(device)
    fa.launches = dm.launches = 0
    for i, (label, art, want) in enumerate(plan):
        d0 = dm.launches
        t0 = time.perf_counter()
        params, opt, m = art.train_step(params, opt, next(batches))
        _sync(device)
        sec = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        n = dm.launches - d0
        steps.append(dict(backward=label, ms=sec * 1e3, loss=loss,
                          grad_norm=gnorm, launches=n, lr=float(m["lr"])))
        log(f"  step {i + 1} ({label:6s} backward) {sec * 1e3:9.1f} ms  loss "
            f"{loss:.4f}  grad_norm {gnorm:.4f}  lr {float(m['lr']):.3g}  "
            f"daism_matmul launches {n} (sites imply {want})")
        if not (math.isfinite(loss) and math.isfinite(gnorm)) or n != want:
            raise SystemExit(f"train step {i + 1}: loss {loss}, grad_norm "
                             f"{gnorm}, {n} launches where {want} are implied")
    if fa.launches:
        raise SystemExit("the train steps launched the flash kernel")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"  peak device memory {peak:.1f} GiB (bf16 params, f32 master/m/v)")
    launches = dm.launches
    del params, opt, ste, approx
    _free(device)
    return steps, launches, peak


# ---------------------------------------------------------------------------
# phase 5: numbers
# ---------------------------------------------------------------------------

def measure(device, variants):
    """GEMM kernel / plain / library times and bounds; every timed kernel
    output is held against the timed plain output (phase 3's bound).
    Returns (rows, max |kernel - plain|)."""
    import torch

    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    # (M, K, N, variants, plain version's reps): the prefill and train
    # shapes are larger and take their plain time from one call
    cases = [(m, k, n, variants, 2) for k, n in KN_SHAPES for m in M_SHAPES]
    cases += [(m, k, n, ["pc3_tr", "exact"], 1)
              for m, k, n in PREFILL_GEMM_SHAPES + TRAIN_GEMM_SHAPES]
    max_err = 0.0
    for m, k, n, case_variants, plain_reps in cases:
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        for v in case_variants:
            ms, got = cuda_time_ms(lambda: dm.daism_matmul_kernel(a, w, v), 10)
            plain_ms, ref = cuda_time_ms(
                lambda: dm.daism_matmul_plain(a, w, v), plain_reps,
                warmup=plain_reps - 1)
            err, rel = gemm_held(got, ref, a, w, f"{v} ({m},{k},{n})")
            max_err = max(max_err, err)
            del got, ref
            lib_ms = None
            if v == "exact":
                lib_ms, _ = cuda_time_ms(
                    lambda: torch.matmul(a.float(), w.float()), 10)
            b_ms, b_by, ops = bound(v, m, k, n)
            rows.append(dict(variant=v, m=m, k=k, n=n, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by, ops=ops,
                             max_abs_err=err, max_rel_err=rel))
            lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
            log(f"  {v:7s} M={m:4d} K={k:5d} N={n:6d}  kernel "
                f"{ms:9.4f} ms  plain {plain_ms:10.3f} ms  library "
                f"{lib:>8s} ms  bound {b_ms:.4f} ms ({b_by}, "
                f"{ops:.3e} ops)  {b_ms / ms * 100:5.1f}% of bound  "
                f"|kernel - plain| {err:.3g} = {rel:.3g} (|a|@|w|) "
                f"<= {gemm_rtol(k):.3g}")
        del a, w
        _free(device)
    return rows, max_err


def measure_flash(device):
    """Kernel / plain / SDPA times at TinyLlama's heads, S = 2048, causal;
    each timed kernel output is held against the timed plain output (phase
    3's bounds), and the exact and FLA kernels against the PC3_TR plain
    output must break the approximate bound (a control: the bound tells
    another function apart). Returns (rows, max |kernel - plain|)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.config import Variant
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kh, d = (FLASH_TIMED[i] for i in (0, 1, 3, 4, 5))
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v = _bhsd_inputs(gen, device, *FLASH_TIMED)
    # SDPA's inputs: (B, H, S, D) with the kv heads expanded beforehand
    qs, ks, vs = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
                  for t in (q, k, v))
    rows, outs, plains = [], {}, {}
    errs = {"exact": 0.0, "approx": 0.0, "approx_over_2ulp": -1.0}
    for var in [None] + [x for x in Variant if x is not Variant.EXACT]:
        name = var.value if var else "exact"
        ms, outs[name] = cuda_time_ms(lambda: fa.flash_attention_bhsd_kernel(
            q, k, v, variant=var), 5)
        plain_ms, plains[name] = cuda_time_ms(
            lambda: fa.flash_attention_bhsd_plain(q, k, v, variant=var), 1,
            warmup=0)
        _flash_held(outs[name], plains[name], var,
                    f"{FLASH_TIMED} causal {name}", errs)
        err = (outs[name].float() - plains[name].float()).abs().max().item()
        lib_ms = None
        if var is None:
            lib_ms, _ = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), 10)
        b_ms, b_by, ops = flash_bound(name, b, s, h, kh, d)
        rows.append(dict(variant=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         ops=ops, max_abs_err=err))
        lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
        log(f"  flash {name:7s} B={b} S={s} H={h} KH={kh} D={d} causal  "
            f"kernel {ms:9.4f} ms  plain {plain_ms:10.3f} ms  SDPA "
            f"{lib:>8s} ms  bound {b_ms:.4f} ms ({b_by}, {ops:.3e} ops)  "
            f"{b_ms / ms * 100:5.1f}% of bound  |kernel - plain| {err:.4g}")
    log(f"  flash at {FLASH_TIMED}: all 7 variants within the bounds; max "
        f"|kernel - plain| exact {errs['exact']:.4g}, approximate "
        f"{errs['approx']:.4g} (largest excess over 2**-6 |plain| "
        f"{errs['approx_over_2ulp']:.4g}, allowed {FLASH_APPROX_TOL[0]:g})")
    for other in ("exact", "fla"):
        err, excess, bnd = flash_excess(outs[other], plains["pc3_tr"],
                                        Variant.PC3_TR)
        log(f"  control: {other} kernel vs pc3_tr plain: max |diff| "
            f"{err:.4g}, exceeds {bnd} by {excess:.4g}")
        if excess <= 0:
            raise SystemExit(f"flash control: the {other} kernel's output "
                             "passes the approximate bound against the "
                             "pc3_tr plain version; the bound cannot tell "
                             "the two functions apart")
    return rows, max(errs["exact"], errs["approx"])


def build_all():
    """nvcc of every kernel source, all started together; returns
    {name: (path, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import compile_library

    def one(name):
        t0 = time.perf_counter()
        path = compile_library(name, verbose=True)
        return name, (path, time.perf_counter() - t0)

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(pool.map(one, KERNELS))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=22,
                   help="depth of the served, prefilled and trained model "
                        "(TinyLlama has 22; width is never cut)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.core.config import Variant

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    log("== 1. device ==")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{name}, count {torch.cuda.device_count()}; TF32 off")

    log("== 2. build ==")
    t0 = time.perf_counter()
    for lib, (path, sec) in build_all().items():
        log(f"  built {path.relative_to(ROOT)} in {sec:.1f} s")
    log(f"  build wall {time.perf_counter() - t0:.1f} s")

    log("== 3. kernels vs plain versions ==")
    max_err = check_kernel(device)
    flash_errs = check_flash(device)

    cfg = get_config("tinyllama_1_1b")
    if args.layers != cfg.n_layers:
        log(f"  depth cut: {args.layers} of {cfg.n_layers} layers "
            "(width kept)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    log("== 4. serve ==")
    report, serve_launches = serve(device, cfg)
    _free(device)

    log("== 5. prefill ==")
    pre, pre_flash, pre_gemm = prefill(device, cfg)

    log("== 6. train ==")
    steps, train_gemm, peak_gib = train(device, cfg)

    log("== 7. numbers ==")
    rows, gemm_err = measure(device, [v.value for v in Variant])
    frows, flash_err = measure_flash(device)
    log("  serve: " + report.summary().replace("\n", "\n  serve: "))
    for label, r in pre.items():
        if "ms" in r:
            log(f"  prefill {label}: {r['ms']:.1f} ms per forward, "
                f"{r['tok_s']:.1f} tok/s")
    for i, st in enumerate(steps):
        log(f"  train step {i + 1} ({st['backward']}): {st['ms']:.1f} ms")
    rep = next(r for r in rows if (r["variant"], r["m"], r["k"], r["n"])
               == REPRESENTATIVE)
    frep = {r["variant"]: r for r in frows}
    record = {"kernels": [{
        "name": "daism_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/daism_matmul.cu",
        "replaces": "src/repro/kernels/daism_matmul.py:43",
        "launches": serve_launches + pre_gemm + train_gemm,
        "max_abs_err": max(max_err, gemm_err),
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "variant": rep["variant"],
        "shape": [rep["m"], rep["k"], rep["n"]],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:54",
        "launches": pre_flash,
        "max_abs_err": max(flash_errs["exact"], flash_errs["approx"],
                           flash_err),
        "ms": frep["exact"]["ms"],
        "plain_ms": frep["exact"]["plain_ms"],
        "bound_ms": frep["exact"]["bound_ms"],
        "bound_by": frep["exact"]["bound_by"],
        "library_ms": frep["exact"]["library_ms"],
        "variant": "exact",
        "shape": list(FLASH_TIMED),
        "approx": {k: frep["pc3_tr"][k] for k in
                   ("variant", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
    }]}
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
