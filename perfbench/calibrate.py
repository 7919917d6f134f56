#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 [--fault alter_token]

In one process (set-up is long), each seed runs the cell's driver as a
benchmark run does, with a short window, and prints the numbers it
compared: ``--seeds`` with the program (the lower readings),
``--control-seeds`` with the control in the program's place (the
reference in float8, the upper readings), ``--fault`` with the named
fault planted in the program's output. One JSON line a seed on standard
output. Needs the card, as a run does.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def readings(cell_name: str, seeds, *, seconds: float, control=False,
             fault=None, device=None):
    """Yield ``{seed, control, fault, checks}`` for each seed."""
    from perfbench import harness

    import torch

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry, workload, config = harness.find_cell(bench, cell_name)
    for seed in seeds:
        cell = harness.Cell(name=cell_name, entry=entry, workload=workload,
                            config=config, seed=seed, seconds=seconds,
                            trace=False,
                            device=device or torch.device("cuda", 0))
        out = harness.driver_module(cell.kind).run(
            cell, time.time(), harness.Spans(), control=control, fault=fault)
        yield {"seed": seed, "control": control, "fault": fault,
               "checks": out["checks"].values, "notes": out["checks"].notes,
               "correct": out["checks"].correct}
        del out
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for path in (str(ROOT), str(ROOT / "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: calibrate needs a CUDA card", file=sys.stderr)
        return 2
    for seeds, control in ((_seeds(args.seeds), False),
                           (_seeds(args.control_seeds), True)):
        for rec in readings(args.workload, seeds, seconds=args.seconds,
                            control=control, fault=args.fault):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
