"""What every cell shares: the cell's files found by name, the clock, spans,
the profiler trace and its reduction, the statistics and the result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``. Its traffic is
``perfbench/workloads/<cell>.json`` (the driver kind, the policy and the
traffic parameters), its configuration ``perfbench/configs/<config>.json``,
its driver ``perfbench/drivers/<kind>.py`` and each per-layer metric a
reader ``perfbench/metrics/<metric>.py``. Nothing here names a cell.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# modules no run may load: the JAX package and JAX itself (top-level
# names, compared whole: ``repro_torch`` is the program, not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import ``path`` as module ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One run of one cell."""

    name: str
    entry: dict                 # the BENCHMARK.json workload entry
    workload: dict              # workloads/<cell>.json
    config: dict                # configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: Any = None
    root: Path = ROOT

    @property
    def kind(self) -> str:
        return self.workload["driver"]


def find_cell(bench: dict, name: str, bench_dir: Path = BENCH) -> tuple:
    """(entry, workload file, config file) of cell ``name``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    config = load_json(bench_dir / "configs" / f"{entry['config']}.json")
    return entry, workload, config


def driver_module(kind: str, bench_dir: Path = BENCH):
    return load_module(bench_dir / "drivers" / f"{kind}.py",
                       f"perfbench_driver_{kind}")


def metric_reader(name: str, bench_dir: Path = BENCH) -> Callable:
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_")).read


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``cell`` reports: those that list it, or list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_loaded() -> List[str]:
    """Top-level names of loaded modules that no run may load."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# ---------------------------------------------------------------------------
# statistics (frozen copies of the usual definitions)
# ---------------------------------------------------------------------------

def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile (numpy's default), 0 for no data."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        return 0.0
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    return work / seconds if seconds > 0 else 0.0


# ---------------------------------------------------------------------------
# the window's steps, for standard error
# ---------------------------------------------------------------------------

def step_lines(spans: "Spans", least: int = 20) -> List[str]:
    """For each span name with ``least`` or more spans (a window's steps or
    ticks): its host times in ms, p10 / p50 / p90 / max, the first 20 apart,
    and the median of each tenth of the spans in order."""
    out = []
    for name in dict.fromkeys(n for n, _, _ in spans.spans):
        xs = [1e3 * s for s in spans.seconds(name)]
        if len(xs) < least:
            continue
        tenths = [percentile(xs[len(xs) * i // 10:len(xs) * (i + 1) // 10],
                             50) for i in range(10)]

        def ms(v):
            return " ".join(f"{x:.1f}" for x in v)

        out.append(
            f"steps {name} n={len(xs)} ms p10={percentile(xs, 10):.1f} "
            f"p50={percentile(xs, 50):.1f} p90={percentile(xs, 90):.1f} "
            f"max={max(xs):.1f} first20=[{ms(xs[:20])}] "
            f"tenths=[{ms(tenths)}]")
    return out


# ---------------------------------------------------------------------------
# spans and the profiler
# ---------------------------------------------------------------------------

class Spans:
    """Host-clock spans of the benchmark's own calls into the program's
    layers; under a trace each is also a profiler range, so an idle gap on
    the device can be charged to the span the host was in."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        if self.profiling:
            import torch

            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                self.spans.append((name, t0, time.perf_counter()))
        else:
            t0 = time.perf_counter()
            yield
            self.spans.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACED = "perfbench.traced"


@dataclasses.dataclass
class TraceSummary:
    """The device's side of a traced segment, from the profiler's trace."""

    window_s: float
    busy_s: float
    kernels: Dict[str, float]           # device op name -> seconds
    gaps: Dict[str, float]              # host span -> idle seconds

    def kernel_seconds(self, patterns) -> float:
        return sum(s for n, s in self.kernels.items()
                   if any(p in n for p in patterns))

    def breakdown(self) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize_trace(events: List[dict]) -> Optional[TraceSummary]:
    """Reduce chrome-trace events to the traced window's busy time, device
    time by op name, and idle gaps charged to the innermost host span (a
    ``record_function`` range) open at the gap's middle. None when the
    window is missing or the device ran nothing."""
    win = [e for e in events if e.get("name") == TRACED and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    kernels: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
                kernels[e["name"]] = kernels.get(e["name"], 0.0) + (b - a) / 1e6
    if not dev:
        return None
    busy = _union(dev)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e.get("name") != TRACED]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                 else "outside any span")
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return TraceSummary(window_s=(w1 - w0) / 1e6,
                        busy_s=sum(b - a for a, b in busy) / 1e6,
                        kernels=kernels, gaps=gaps)


@contextlib.contextmanager
def traced(cell: Cell, spans: Spans, out: dict):
    """Profile the block (CPU and CUDA activities); on exit
    ``out["trace"]`` holds its :class:`TraceSummary` (or None). The
    chrome trace is written under ``build/perfbench/`` in the checkout."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = cell.root / "build" / "perfbench" / f"trace-{cell.name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    spans.profiling = True
    try:
        with torch.profiler.record_function(TRACED):
            yield
            torch.cuda.synchronize()
    finally:
        spans.profiling = False
        prof.stop()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out["trace"] = summarize_trace(events)


# ---------------------------------------------------------------------------
# the checks that decide ``correct``
# ---------------------------------------------------------------------------

class Checks:
    """Numbers compared with their limits (``workloads/<cell>.json``
    ``limits``); ``correct`` is every number within its limit."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}
        self.notes: Dict[str, float] = {}   # read, not compared

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for check {name!r}")
        self.values[name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(
            math.isfinite(v) and v <= self.limits[n]
            for n, v in self.values.items())

    def record(self) -> dict:
        return {n: {"value": v, "limit": self.limits[n]}
                for n, v in self.values.items()}

    def lines(self) -> List[str]:
        return ([f"note {n} {v!r} (not compared)"
                 for n, v in self.notes.items()]
                + [f"check {n} {v!r} limit {self.limits[n]!r}"
                   for n, v in self.values.items()])
