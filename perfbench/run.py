#!/usr/bin/env python3
"""Run one benchmark cell once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's files are found by its name
(``perfbench/harness.py``); the program is ``src/repro_torch``, built by
its own first use into ``build/repro_torch/`` inside the checkout.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones (a profiled segment after the window). The last line of
standard output is one JSON object; the last lines of standard error are
the numbers that decided ``correct``, each beside its limit, after the
spans and the window's step times (``steps``). Without as many CUDA
cards as the cell asks for, or with the JAX package or JAX loaded at the
end, the run prints no result and exits 2 or 3.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def main(argv=None) -> int:
    args = _args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    _caches()
    from perfbench import harness

    t_start = harness.process_start()
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry, workload, config = harness.find_cell(bench, args.workload)

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print(f"perfbench: cell {args.workload} needs {entry['chips']} CUDA "
              "card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.Cell(name=args.workload, entry=entry, workload=workload,
                        config=config, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device=device)
    spans = harness.Spans()
    out = harness.driver_module(cell.kind).run(cell, t_start, spans)
    line = result_line(bench, cell, out)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name in dict.fromkeys(n for n, _, _ in spans.spans):
        xs = spans.seconds(name)
        print(f"span {name} n={len(xs)} s={sum(xs):.3f}", file=sys.stderr)
    for text in harness.step_lines(spans):
        print(text, file=sys.stderr)
    for text in out["checks"].lines():
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


def result_line(bench: dict, cell, out: dict) -> dict:
    """The result object: ``--trace 0`` the cell's end-to-end metrics,
    ``--trace 1`` its per-layer ones; the checks come last."""
    from perfbench import harness

    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.entry["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if cell.trace:
        layer = out["layer"]
        tr = layer.get("trace")
        if tr is not None:
            device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        for m in harness.cell_metrics(bench, cell.name, "per_layer"):
            value = harness.metric_reader(m["name"])(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(bench, cell.name, "end_to_end"):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out["checks"].correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace and out["layer"].get("trace") is not None:
        line["breakdown"] = out["layer"]["trace"].breakdown()
    line["checks"] = out["checks"].record()
    return line


if __name__ == "__main__":
    sys.exit(main())
