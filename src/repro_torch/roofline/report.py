"""The dry-run and roofline tables from ``results/``.

    PYTHONPATH=src python -m repro_torch.roofline.report [--tag main]

The port of ``repro/roofline/report.py``: the same tables, from the port's
results file ``results/dryrun_torch_{tag}.json`` (``launch/dryrun.py``).
"""
from __future__ import annotations

import argparse
import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results")


def _fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def load(tag):
    with open(os.path.join(RESULTS, f"dryrun_torch_{tag}.json")) as f:
        return json.load(f)


def dryrun_table(recs) -> str:
    lines = ["| arch | shape | mesh | compile s | mem/dev GB | args GB | temps GB | dominant collective |",
             "|---|---|---|---:|---:|---:|---:|---|"]
    for v in sorted(recs.values(), key=lambda v: (v["arch"], v["shape"],
                                                  v["mesh"])):
        if v["status"] == "skip":
            lines.append(f"| {v['arch']} | {v['shape']} | {v['mesh']} | "
                         f"— | — | — | — | *mandated skip* |")
            continue
        if v["status"] != "ok":
            lines.append(f"| {v['arch']} | {v['shape']} | {v['mesh']} | "
                         f"ERROR | | | | {v.get('error', '')[:60]} |")
            continue
        dom = max(v["collective_by_op"].items(), key=lambda kv: kv[1],
                  default=("none", 0))
        lines.append(
            f"| {v['arch']} | {v['shape']} | {v['mesh']} | "
            f"{v['compile_s']:.0f} | {v['mem_per_device_gb']:.2f} | "
            f"{_fmt_bytes(v['arg_bytes'])} | {_fmt_bytes(v['temp_bytes'])} | "
            f"{dom[0]} ({dom[1] / 2**30:.1f} GB) |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "bottleneck | MODEL_FLOPS | useful | peak frac |",
             "|---|---|---:|---:|---:|---|---:|---:|---:|"]
    for v in sorted(recs.values(), key=lambda v: (v["arch"], v["shape"])):
        if v["status"] != "ok" or v["mesh"] != "single":
            continue
        tmax = max(v["compute_s"], v["memory_s"], v["collective_s"], 1e-30)
        lines.append(
            f"| {v['arch']} | {v['shape']} | {v['compute_s']:.4f} | "
            f"{v['memory_s']:.4f} | {v['collective_s']:.4f} | "
            f"{v['bottleneck']} | {v['model_flops']:.3e} | "
            f"{v['useful_ratio']:.2f} | {v['compute_s'] / tmax:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tag", default="main")
    p.add_argument("--which", default="both",
                   choices=["dryrun", "roofline", "both"])
    args = p.parse_args(argv)
    recs = load(args.tag)
    if args.which in ("dryrun", "both"):
        print("### Dry-run table\n")
        print(dryrun_table(recs))
    if args.which in ("roofline", "both"):
        print("\n### Roofline table (single-pod)\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
