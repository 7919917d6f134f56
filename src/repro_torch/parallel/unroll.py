"""Ambient per-category scan-unroll control (roofline probe machinery).

A copy of ``repro/parallel/unroll.py``, kept for the API: the port has no
scans (its layer stacks and recurrences are Python loops), so nothing in
it reads these settings, and its dry-run runs no probes
(``launch/dryrun.py::loop_accounting`` records the reference's plan).
The reference's text follows.

XLA's HLO cost analysis counts a while-loop body once regardless of trip
count. To recover true per-device bytes/collective traffic from the compiled
artifact, the dry-run compiles PROBE variants of each cell with one scan
category unrolled by k: the cost delta equals (k-1) x (sum of that
category's loop bodies), from which the true trip-weighted total is
reconstructed (EXPERIMENTS.md §Roofline: methodology). Categories:

  layers — the stacked-parameter layer scans
  attn   — the online-softmax KV-chunk scans
  time   — SSM/xLSTM per-timestep recurrence scans

Default is 1 everywhere (production graphs are untouched).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

_tls = threading.local()

_DEFAULT = {"layers": 1, "attn": 1, "time": 1}


def unroll_for(category: str) -> int:
    cfg = getattr(_tls, "unroll", None)
    if cfg is None:
        return 1
    return cfg.get(category, 1)


@contextlib.contextmanager
def use_unroll(**categories: int):
    prev = getattr(_tls, "unroll", None)
    cfg = dict(_DEFAULT)
    if prev:
        cfg.update(prev)
    cfg.update(categories)
    _tls.unroll = cfg
    try:
        yield
    finally:
        _tls.unroll = prev
