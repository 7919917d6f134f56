#!/usr/bin/env python3
"""Compare checkouts of this repo on one card, in turns.

    git archive <parent> | tar -x -C build/parent      # a gitignored directory
    python3 tools/ab_trees.py build/parent .           # on a machine with one H100
    python3 tools/ab_trees.py build/parent . --what kernels [--prefill]

Each tree runs in a process of its own, through its own wrappers (so the
trees' C signatures need not agree), in rounds that alternate the order
(A B, B A, ...), so that a drift of the card or of the host during the
call shows as a spread within a tree rather than as a difference between
the trees. Each process builds its tree's kernels, then:

* ``--what serve`` (default): times the approximate GEMM through its
  wrapper (PC3_TR, CUDA events over 50 calls, the host's cost included) at
  decode shapes and runs its tree's ``chip_smoke.py`` serve phase
  (TinyLlama-1.1B at full width, two tiers);
* ``--what kernels``: times the approximate GEMM (CUDA events over 10
  calls) at the decode, prefill-chunk and prefill shapes and the
  approximate flash kernel (3 calls) at every approximate shape the main
  paths time, each output's bytes hashed; with ``--prefill`` also
  TinyLlama's PC3_TR ``:flash`` prefill forward (22 layers at published
  width, random weights, B = 1, S = 2048) on the host clock after a sync.

Prints one JSON line a process and, per metric, each tree's median and
range (and, for a kernel, its share of the bound chip_smoke.py computes);
in ``kernels`` mode it fails unless every tree gave the same bits.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = [(1, 2048, 256), (4, 2048, 256), (4, 2048, 2048), (4, 2048, 5632),
          (128, 2048, 5632)]

# kernels mode: (variant, M, K, N) of the approximate GEMM, and
# (label, (B, Sq, Skv, H, KH, D), causal, variants) of the flash kernel
KERNEL_GEMMS = ([("pc3_tr", m, k, n) for m in (1, 4, 128, 2048)
                 for k, n in ((2048, 2048), (2048, 256), (2048, 5632),
                              (5632, 2048), (2048, 32000))]
                + [(v, m, 2048, 5632) for v in ("fla", "hla", "pc2", "pc3",
                                                "pc2_tr")
                   for m in (4, 2048)])
KERNEL_FLASH = [
    ("tinyllama", (1, 2048, 2048, 32, 4, 64), True,
     ("fla", "hla", "pc2", "pc3", "pc2_tr", "pc3_tr")),
    ("gemma_2b", (1, 2048, 2048, 8, 1, 256), True, ("pc3_tr",)),
    ("nemotron_4_340b", (1, 2048, 2048, 96, 8, 192), True, ("pc3_tr",)),
    ("whisper encoder self", (1, 1500, 1500, 20, 20, 64), False, ("pc3_tr",)),
    ("whisper decoder cross", (1, 448, 1500, 20, 20, 64), False, ("pc3_tr",)),
    ("whisper decoder self", (1, 448, 448, 20, 20, 64), True, ("pc3_tr",)),
    ("f32 exact", (1, 512, 512, 8, 2, 128), True, ("exact",)),
]

CHILD_SERVE = r'''
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import daism_matmul as dm

dev = torch.device("cuda", 0)
cs.build_all()
gen = torch.Generator(device=dev).manual_seed(0)
res = {}
for m, k, n in SHAPES:
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    res[f"{m},{k},{n}"] = cs.cuda_time_ms(
        lambda: dm.daism_matmul_kernel(a, w, "pc3_tr"), 50)[0]
report, _ = cs.serve(dev, get_config("tinyllama_1_1b"))
res["tokens_per_s"] = report.tokens_per_s
res["ttft_p50_ms"] = report.ttft_p50_ms
res["decode_step_p50_ms"] = report.step_p50_ms
print("RESULT " + json.dumps(res), flush=True)
'''

CHILD_KERNELS = r'''
import hashlib, json, sys, time
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.core.config import Variant
from repro_torch.kernels import daism_matmul as dm
from repro_torch.kernels import flash_attention as fa

def digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]

dev = torch.device("cuda", 0)
cs.build_all()
res, bits = {}, {}
gen = torch.Generator(device=dev).manual_seed(0)
for v, m, k, n in GEMMS:
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    key = f"gemm {v} {m},{k},{n} ms"
    res[key], out = cs.cuda_time_ms(lambda: dm.daism_matmul_kernel(a, w, v), 10)
    bits[key] = digest(out)
for label, shape, causal, variants in FLASH:
    gen = torch.Generator(device=dev).manual_seed(4)
    dtype = torch.float32 if variants == ["exact"] else torch.bfloat16
    q, k, v = cs._bhsd_inputs(gen, dev, *shape, dtype=dtype)
    for name in variants:
        var = None if name == "exact" else Variant(name)
        key = f"flash {label} {name} ms"
        res[key], out = cs.cuda_time_ms(lambda: fa.flash_attention_bhsd_kernel(
            q, k, v, causal=causal, variant=var), 3)
        bits[key] = digest(out)
    del q, k, v
if PREFILL:
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts
    cfg = get_config("tinyllama_1_1b")
    spec = "*/attn/kernel=pc3_tr:flash,*=pc3_tr:pallas"
    params = build_artifacts(cfg, device=dev).init_params(0)
    tokens = next(lm_batches(cfg.vocab, 1, 2048, seed=0))["tokens"]
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    art = build_artifacts(cfg.with_policy(spec), device=dev)
    times = []
    for _ in range(3):  # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = art.prefill_step(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    key = "prefill tinyllama_1_1b pc3_tr:flash B=1 S=2048 ms"
    res[key] = min(times[1:])
    bits[key] = digest(logits)
print("RESULT " + json.dumps(res), flush=True)
print("BITS " + json.dumps(bits), flush=True)
'''


def bounds() -> dict:
    """{kernels-mode key: bound ms} from chip_smoke.py's bounds."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    out = {f"gemm {v} {m},{k},{n} ms": cs.bound(v, m, k, n)[0]
           for v, m, k, n in KERNEL_GEMMS}
    for label, (b, sq, skv, h, kh, d), causal, variants in KERNEL_FLASH:
        for name in variants:
            if name != "exact":
                out[f"flash {label} {name} ms"] = cs.flash_bound(
                    name, b, sq, h, kh, d, skv=skv, causal=causal)[0]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", type=Path, nargs="+", help="two or more roots")
    p.add_argument("--pairs", type=int, default=2,
                   help="rounds over the trees, alternating their order")
    p.add_argument("--what", choices=("serve", "kernels"), default="serve")
    p.add_argument("--prefill", action="store_true",
                   help="kernels mode: also TinyLlama's :flash prefill")
    args = p.parse_args()
    if len(args.trees) < 2:
        p.error("give at least two trees")
    if args.what == "serve":
        child = f"SHAPES = {SHAPES!r}\n" + CHILD_SERVE
    else:
        child = (f"GEMMS = {KERNEL_GEMMS!r}\n"
                 f"FLASH = {json.loads(json.dumps(KERNEL_FLASH))!r}\n"
                 f"PREFILL = {args.prefill!r}\n" + CHILD_KERNELS)
    runs = {str(t): [] for t in args.trees}
    bits = {str(t): None for t in args.trees}
    order = []
    for i in range(args.pairs):
        order += args.trees if i % 2 == 0 else args.trees[::-1]
    for tree in order:
        proc = subprocess.run([sys.executable, "-c", child], cwd=tree,
                              capture_output=True, text=True)
        lines = {l.split(" ", 1)[0]: json.loads(l.split(" ", 1)[1])
                 for l in proc.stdout.splitlines()
                 if l.startswith(("RESULT ", "BITS "))}
        if proc.returncode != 0 or "RESULT" not in lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        runs[str(tree)].append(lines["RESULT"])
        bits[str(tree)] = lines.get("BITS")
        print(f"{tree}: {json.dumps(lines['RESULT'])}", flush=True)
    bound = bounds() if args.what == "kernels" else {}
    for key in runs[str(args.trees[0])][0]:
        line = []
        for tree, rs in runs.items():
            vals = sorted(r[key] for r in rs)
            med = statistics.median(vals)
            line.append(f"{tree} median {med:.6g} range {vals[0]:.6g}-"
                        f"{vals[-1]:.6g}" + (f" ({bound[key] / med * 100:.1f}%"
                                             " of bound)" if key in bound
                                             else ""))
        print(f"{key}: " + "; ".join(line)
              + (f"; bound {bound[key]:.6g} ms" if key in bound else ""),
              flush=True)
    if args.what == "kernels":
        first = bits[str(args.trees[0])]
        differ = [key for key in first
                  if len({b[key] for b in bits.values()}) > 1]
        print(f"outputs bit for bit equal across the trees: "
              f"{len(first) - len(differ)} of {len(first)}"
              + (f"; differ: {differ}" if differ else ""), flush=True)
        return 1 if differ else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
