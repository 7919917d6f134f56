"""What the engine's span metrics read: the port's own span records of the
profiled segment (``repro_torch.runtime.trace.records()``: the port records
spans exactly while a profiler records, and keeps the latest session's),
the segment's idle gaps (``layer["trace"].gaps``), each charged to the
innermost range open at its middle, and the segment's chrome trace, whose
device ops join the port's ranges through their launching calls.

Each reader returns None where the program has no span module, or where
the records hold nothing for it; never 0 for a share.
"""
from __future__ import annotations

import bisect
import json

from perfbench import harness

# an idle gap in a launch: the device waits while the host issues a step
LAUNCH_SPANS = ("engine.launch", "engine.stage")
# an idle gap in the engine's bookkeeping around the launches
HOST_SPANS = ("engine.tick", "engine.blocks", "engine.swap", "engine.admit",
              "engine.apply", "engine.fetch")


def port_records():
    """The port's span records, or None where it has no span module."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    return trace.records()


def _records(records):
    return port_records() if records is None else records


def in_launch(label: str) -> bool:
    return label in LAUNCH_SPANS or label.startswith("model.")


def in_host(label: str) -> bool:
    return label in HOST_SPANS


def idle_share(layer: dict, charged, records=None):
    """Idle seconds charged to a span that ``charged`` accepts, over the
    segment (%); None unless the port's engine spans were recorded."""
    tr, recs = layer.get("trace"), _records(records)
    if (tr is None or tr.window_s <= 0 or not recs
            or not any(r.name == "engine.tick" for r in recs)):
        return None
    return 100.0 * sum(s for n, s in tr.gaps.items()
                       if charged(n)) / tr.window_s


def launches(records, kind: str):
    return [r for r in records
            if r.name == "engine.launch" and r.attrs.get("kind") == kind]


def launch_ms_p50(records=None):
    """Median host time of the segment's decode launches, ms."""
    xs = [r.ms for r in launches(_records(records) or [], "decode")]
    return harness.percentile(xs, 50) if xs else None


def prefill_pad_share(records=None):
    """Padding's share of the positions the prefill launches ran (%)."""
    pre = launches(_records(records) or [], "prefill")
    positions = sum(r.attrs["positions"] for r in pre)
    if not positions:
        return None
    return 100.0 * (1.0 - sum(r.attrs["tokens"] for r in pre) / positions)


# the kernel modules' counters that ``engine.launch`` carries
KERNEL_COUNTERS = ("daism_matmul.launches", "daism_matmul.sum_launches",
                   "flash_attention.launches")


def launches_per_decode(records=None):
    """Hand-written kernel launches a decode step issues: the mean over the
    segment's decode launches of their kernel counters' changes."""
    dec = launches(_records(records) or [], "decode")
    if not dec:
        return None
    return sum(r.attrs.get(k, 0) for r in dec
               for k in KERNEL_COUNTERS) / len(dec)


def trace_events(layer: dict, directory=None):
    """The chrome-trace events of the segment ``layer["trace"]`` sums up:
    the newest ``trace-*.json`` under ``build/perfbench/`` whose traced
    window lasts ``window_s``; None where there is none."""
    tr = layer.get("trace")
    if tr is None:
        return None
    directory = directory or harness.ROOT / "build" / "perfbench"
    files = sorted(directory.glob("trace-*.json"),
                   key=lambda p: p.stat().st_mtime, reverse=True)
    for path in files:
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        win = [e for e in events
               if e.get("name") == harness.TRACED and "dur" in e]
        if win and abs(float(win[0]["dur"]) / 1e6 - tr.window_s) < 1e-6:
            return events
    return None


def _ranges(events, name):
    """Sorted (start, end) of the host ranges named ``name``."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("name") == name
                  and e.get("cat") == "user_annotation" and "dur" in e)


def _inside(t, ranges) -> bool:
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def range_device_s(events, names):
    """Device seconds of the ops launched inside each range of ``names``
    (a device op joins the host call that launched it by correlation id;
    the call's start must lie in the range)."""
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if (corr is not None and e.get("ph") == "X"
                and e.get("cat") not in harness.DEVICE_CATS
                and e.get("cat") != "gpu_user_annotation"):
            launched[corr] = float(e["ts"])
    ranges = {n: _ranges(events, n) for n in names}
    out = dict.fromkeys(names, 0.0)
    for e in events:
        if e.get("cat") not in harness.DEVICE_CATS or "dur" not in e:
            continue
        t = launched.get((e.get("args") or {}).get("correlation"))
        if t is None:
            continue
        for n in names:
            if _inside(t, ranges[n]):
                out[n] += float(e["dur"]) / 1e6
    return out


def lm_head_share(layer: dict, events=None):
    """Device time of the ops launched inside ``model.lm_head`` ranges over
    that of the ops launched inside ``engine.launch`` ranges (%)."""
    events = trace_events(layer) if events is None else events
    if not events:
        return None
    s = range_device_s(events, ("model.lm_head", "engine.launch"))
    head, launch = s["model.lm_head"], s["engine.launch"]
    return 100.0 * head / launch if head > 0 and launch > 0 else None
