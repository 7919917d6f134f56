#!/usr/bin/env python3
"""Compare two checkouts of this repo on one card, in turns.

    git archive <parent> | tar -x -C build/parent      # a gitignored directory
    python3 tools/ab_trees.py build/parent .           # on a machine with one H100

Each tree runs in a process of its own, in pairs that alternate which
tree goes first (A B, B A, A B, ...), so that a drift of the card or of
the host during the call shows as a spread within a tree rather than as
a difference between the trees. Each process builds
its tree's kernels, times the approximate GEMM through its wrapper
(PC3_TR, CUDA events over 50 calls, the host's cost included) at decode
shapes, and runs its tree's ``chip_smoke.py`` serve phase (TinyLlama-1.1B
at full width, two tiers). Prints one JSON line a process and, per
metric, each tree's median and range.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = [(1, 2048, 256), (4, 2048, 256), (4, 2048, 2048), (4, 2048, 5632),
          (128, 2048, 5632)]

CHILD = r'''
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree_a", type=Path)
    p.add_argument("tree_b", type=Path)
    p.add_argument("--pairs", type=int, default=2,
                   help="pairs of runs, alternating which tree goes first")
    args = p.parse_args()
    child = f"SHAPES = {SHAPES!r}\n" + CHILD
    runs = {str(args.tree_a): [], str(args.tree_b): []}
    order = []
    for i in range(args.pairs):
        pair = (args.tree_a, args.tree_b)
        order += pair if i % 2 == 0 else pair[::-1]
    for tree in order:
        proc = subprocess.run([sys.executable, "-c", child], cwd=tree,
                              capture_output=True, text=True)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        res = json.loads(lines[0][len("RESULT "):])
        runs[str(tree)].append(res)
        print(f"{tree}: {json.dumps(res)}", flush=True)
    for key in runs[str(args.tree_a)][0]:
        line = []
        for tree, rs in runs.items():
            vals = sorted(r[key] for r in rs)
            line.append(f"{tree} median {statistics.median(vals):.6g} "
                        f"range {vals[0]:.6g}-{vals[-1]:.6g}")
        print(f"{key}: " + "; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
