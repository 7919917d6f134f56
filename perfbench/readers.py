"""What the per-layer metric files read, from a run's ``layer`` record:

* ``window``: the measured window's host seconds, its tokens where it
  counts them, and its model FLOPs;
* ``trace``: the profiled segment's :class:`harness.TraceSummary`;
* ``traced``: that segment's bounds (``gemm_bound_s``, ``flash_bound_s``,
  from ``work.py``) and, where the driver counts them, its model FLOPs;
* ``engine``: the serving engine's own timings of the window.

Each returns None where its cell has nothing to read, never 0 for a share.
"""
from __future__ import annotations

from perfbench import harness, work

# the DAISM GEMM's kernels (both paths and the split-K sum) and the
# flash-attention kernels, by their names in the profiler trace
GEMM_KERNELS = ("daism_matmul_approx", "daism_matmul_splitk", "splitk_sum")
FLASH_KERNELS = ("flash_fwd_int", "flash_fwd_tc")


def mfu(layer: dict):
    """Model FLOPs of the window over the bf16 peak for as long."""
    win = layer.get("window")
    if not win or win["seconds"] <= 0 or win["flops"] <= 0:
        return None
    return 100.0 * win["flops"] / (work.PEAK_FLOPS * win["seconds"])


def busy_mfu(layer: dict):
    """Model FLOPs of the traced segment over the bf16 peak for as long as
    the device ran an operation in it."""
    tr, traced = layer.get("trace"), layer.get("traced")
    if tr is None or not traced or tr.busy_s <= 0 or traced.get(
            "flops", 0.0) <= 0:
        return None
    return 100.0 * traced["flops"] / (work.PEAK_FLOPS * tr.busy_s)


def window_rate(layer: dict):
    """The window's tokens over its host seconds."""
    win = layer.get("window")
    if not win or win["seconds"] <= 0 or not win.get("tokens"):
        return None
    return win["tokens"] / win["seconds"]


def roofline(layer: dict, bound: str, patterns):
    """The kernels' least time (summed bounds) over their device time."""
    tr, traced = layer.get("trace"), layer.get("traced")
    if tr is None or not traced or traced.get(bound, 0.0) <= 0:
        return None
    t = tr.kernel_seconds(patterns)
    return 100.0 * traced[bound] / t if t > 0 else None


def idle(layer: dict):
    """Share of the traced segment with no device op running."""
    tr = layer.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * max(tr.window_s - tr.busy_s, 0.0) / tr.window_s


def engine_median_ms(layer: dict, key: str):
    xs = (layer.get("engine") or {}).get(key) or []
    return 1e3 * harness.percentile(xs, 50) if xs else None
