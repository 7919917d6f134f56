#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # on a machine with one NVIDIA H100

Builds the CUDA kernel from the sources in ``src/repro_torch/csrc``, holds it
against its plain PyTorch version on the card, serves TinyLlama-1.1B at its
published width (random bf16 weights from a seed) through the paged engine
with two policy tiers whose approximate GEMMs run in the kernel, and prints
the kernel's times beside its bound. Phases:

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc of every kernel source, timed;
3. kernel   — (a) K = 1 outer products over every pair of normalized bf16
              mantissas with mixed signs and exponents (underflow and
              overflow included): bit-identical to the plain version for the
              six approximate variants; (b) the serving path's GEMM shapes
              (decode M = 4, prefill M = 128) and ragged edges past one
              M tile, for all seven variants within 4e-4 * (|a| @ |w|)
              + 1e-6 (f32 summation order over K <= 5632: K * 2**-24 ~
              3.4e-4);
              (c) an f32 operand raises ValueError;
4. serve    — the engine serves 8 requests through the ``free`` and
              ``paid`` tiers; every request completes at its length, both
              groups run, the prefix cache hits, the kernel's launch count
              equals the count the steps imply, and a small input's logits
              through the kernel agree with the plain (jnp-backend) path;
5. numbers  — kernel / plain / library times (CUDA events) and the bound
              at each shape, and the serve report.

Every check raises on failure and nothing is caught (check 3c expects its
ValueError), so any failure exits non-zero before the final line. TF32 is
off for every f32 matmul here.
The last two lines are the JSON kernel record and the result line.
"""
import argparse
import dataclasses
import json
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
REPRESENTATIVE = ("pc3_tr", 4, 2048, 5632)  # decode-time wi/wg GEMM
TIERS = (("free", "*=pc3_tr:pallas"),
         ("paid", "*/attn/*=exact,*=pc3_tr:pallas"))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
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
        scale = a.double().abs() @ w.double().abs()
        for v in Variant:
            got = dm.daism_matmul_kernel(a, w, v)
            ref = dm.daism_matmul_plain(a, w, v)
            torch.cuda.synchronize()
            err = (got.double() - ref.double()).abs()
            excess = (err - (4e-4 * scale + 1e-6)).max().item()
            if not torch.isfinite(got).all() or excess > 0:
                raise SystemExit(
                    f"{v.value} ({m},{k},{n}): |kernel - plain| exceeds "
                    f"4e-4*(|a|@|w|)+1e-6 by {excess:.3g}")
            max_err = max(max_err, err.max().item())
    log(f"  (b) {len(shapes)} shapes x {len(Variant)} variants within "
        f"4e-4*(|a|@|w|)+1e-6; max |kernel - plain| = {max_err:.6g}")

    f32 = torch.zeros((4, 8), device=device)
    try:
        dm.daism_matmul_kernel(f32, f32.t().contiguous(), Variant.PC3_TR)
    except ValueError:
        log("  (c) f32 operands raise ValueError")
    else:
        raise SystemExit("f32 operands were accepted by the kernel wrapper")
    return max_err


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


# ---------------------------------------------------------------------------
# phase 5: numbers
# ---------------------------------------------------------------------------

def measure(device, variants):
    import torch

    from repro_torch.kernels import daism_matmul as dm

    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for k, n in KN_SHAPES:
        w = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
        for m in M_SHAPES:
            a = torch.randn((m, k), generator=gen,
                            device=device).to(torch.bfloat16)
            for v in variants:
                ms = cuda_time_ms(lambda: dm.daism_matmul_kernel(a, w, v), 10)
                plain_ms = cuda_time_ms(
                    lambda: dm.daism_matmul_plain(a, w, v), 2)
                lib_ms = None
                if v == "exact":
                    lib_ms = cuda_time_ms(
                        lambda: torch.matmul(a.float(), w.float()), 10)
                b_ms, b_by, ops = bound(v, m, k, n)
                rows.append(dict(variant=v, m=m, k=k, n=n, ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by, ops=ops))
                lib = f"{lib_ms:.4f}" if lib_ms is not None else "-"
                log(f"  {v:7s} M={m:3d} K={k:5d} N={n:6d}  kernel "
                    f"{ms:9.4f} ms  plain {plain_ms:10.3f} ms  library "
                    f"{lib:>8s} ms  bound {b_ms:.4f} ms ({b_by}, "
                    f"{ops:.3e} ops)  {b_ms / ms * 100:5.1f}% of bound")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=22,
                   help="serving depth (TinyLlama has 22; width is never cut)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.core.config import Variant
    from repro_torch.kernels.build import compile_library

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
    lib = compile_library("daism_matmul", verbose=True)
    log(f"  built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    log("== 3. kernel vs plain version ==")
    max_err = check_kernel(device)

    log("== 4. serve ==")
    cfg = get_config("tinyllama_1_1b")
    if args.layers != cfg.n_layers:
        log(f"  depth cut: {args.layers} of {cfg.n_layers} layers "
            "(width kept)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    report, launches = serve(device, cfg)

    log("== 5. numbers ==")
    rows = measure(device, [v.value for v in Variant])
    log("  serve: " + report.summary().replace("\n", "\n  serve: "))
    rep = next(r for r in rows if (r["variant"], r["m"], r["k"], r["n"])
               == REPRESENTATIVE)
    record = {"kernels": [{
        "name": "daism_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/daism_matmul.cu",
        "replaces": "src/repro/kernels/daism_matmul.py:43",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"],
        "variant": rep["variant"],
        "shape": [rep["m"], rep["k"], rep["n"]],
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
