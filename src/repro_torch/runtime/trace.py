"""Spans and counters of the serving engine and the model layers.

Tracing is on exactly while a ``torch.profiler`` session is recording: no
flag and no environment variable. Off, :func:`span` returns one shared null
context and records nothing (a module-level bool read and a call). On, a
span appends a :class:`Record` to an in-memory list: the name, the
enclosing record's index, host start and end (``time.perf_counter_ns``) and
``attrs``, the counters taken at the same boundary. A span also opens
``torch.profiler.record_function(name)`` unless given ``annotate=False``,
so its range lies on the device trace's clock in the profiler's chrome
trace (the export: there is no writer here), and the device's kernels join
it through the launching call. Every range nests each op under it one level
deeper, which the profiler charges on each op, so the per-layer spans inside
a launch are records only. :func:`timed` is a span whose host stamps the
caller reads, traced or not: the engine's own clocks are these stamps.

The records are those of the latest profiler session: the first span
recorded after one that saw the profiler off starts a new list. A session
keeps at most ``MAX_RECORDS``; later spans still open their ranges, and
:func:`dropped` counts the records left out.

Span names, matched by the benchmark's readers: ``engine.tick``,
``engine.blocks``, ``engine.swap``, ``engine.launch``, ``engine.stage``,
``engine.admit``, ``engine.fetch``, ``engine.apply`` (``serve/engine.py``);
``model.lm_head`` (``models/layers.py``); records only: ``model.embed``,
``model.attn``, ``model.xattn``, ``model.ffn`` (``models/transformer.py``,
``models/layers.py``). Each ``model.xattn`` record carries the changes of
``cross_kv.kept`` and ``cross_kv.taken`` over it: the cross-attention K/V
reused from the encoder states, or projected and kept there, by a decode
step (``models/layers.py::kept_cross_kv``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 17

_NULL = contextlib.nullcontext()
_RECORDS: List["Record"] = []
_LOCK = threading.Lock()
_OPEN = threading.local()   # per thread: (session, index) of open records
_session = 0                # the current list's number
_seen_off = False           # a span saw the profiler off since the last record
_dropped = 0


@dataclasses.dataclass
class Record:
    """One span: ``parent`` is the index in :func:`records` of the span
    open around it (-1 at the top, or where that span is of an earlier
    session); host stamps in ns."""

    name: str
    parent: int
    start_ns: int
    end_ns: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


def kernel_launches() -> Dict[str, int]:
    """The kernel modules' launch counters: DAISM GEMM calls that launched
    it, their split-K sums, flash-attention launches."""
    from repro_torch.kernels import daism_matmul, flash_attention

    return {"daism_matmul.launches": daism_matmul.launches,
            "daism_matmul.sum_launches": daism_matmul.sum_launches,
            "flash_attention.launches": flash_attention.launches}


def _append(name: str, attrs: dict, stack: list):
    """Add a record under the innermost open one of this session; None
    once the session holds ``MAX_RECORDS``."""
    global _session, _seen_off, _dropped
    with _LOCK:
        if _seen_off:
            _seen_off = False
            _session += 1
            _RECORDS.clear()
            _dropped = 0
        if len(_RECORDS) >= MAX_RECORDS:
            _dropped += 1
            stack.append((_session, -1))
            return None
        top = stack[-1] if stack else None
        parent = top[1] if top is not None and top[0] == _session else -1
        rec = Record(name, parent, 0, attrs=attrs)
        stack.append((_session, len(_RECORDS)))
        _RECORDS.append(rec)
        return rec


class _Span:
    __slots__ = ("name", "annotate", "counters", "attrs", "record",
                 "start_ns", "end_ns", "_rf", "_rec", "_before")

    def __init__(self, name, annotate, counters, attrs, record):
        self.name, self.annotate, self.counters = name, annotate, counters
        self.attrs, self.record = attrs, record

    def __enter__(self):
        if self.record:
            self._rf = None
            if self.annotate:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            self._before = self.counters() if self.counters else None
            self._rec = _append(self.name, self.attrs, stack)
        self.start_ns = time.perf_counter_ns()
        if self.record and self._rec is not None:
            self._rec.start_ns = self.start_ns
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.record:
            rec = self._rec
            if rec is not None:
                rec.end_ns = self.end_ns
                if self._before is not None:
                    after = self.counters()
                    rec.attrs.update((k, after[k] - v)
                                     for k, v in self._before.items())
            _OPEN.stack.pop()
            if self._rf is not None:
                self._rf.__exit__(*exc)
        return False


def span(name: str, *, annotate: bool = True,
         counters: Optional[Callable[[], Dict[str, int]]] = None, **attrs):
    """A traced span named ``name`` with ``attrs``; ``annotate`` also opens
    its profiler range; ``counters`` (a callable returning counts) adds each
    count's change over the span to ``attrs``. Off: a shared null
    context."""
    global _seen_off
    if not _profiler._is_profiler_enabled:
        _seen_off = True
        return _NULL
    return _Span(name, annotate, counters, attrs, True)


def timed(name: str, *,
          counters: Optional[Callable[[], Dict[str, int]]] = None, **attrs):
    """:func:`span`, whose ``start_ns`` / ``end_ns`` are stamped whether or
    not it is traced (then they are the record's own)."""
    global _seen_off
    on = _profiler._is_profiler_enabled
    if not on:
        _seen_off = True
    return _Span(name, True, counters, attrs, on)


def records() -> List[Record]:
    """The records of the latest profiler session, or since :func:`clear`."""
    return _RECORDS


def dropped() -> int:
    """Spans of the latest session left out of :func:`records` (over
    ``MAX_RECORDS``)."""
    return _dropped


def clear() -> None:
    """Forget every record; a span open across it keeps its range and
    gives its children no parent."""
    global _session, _seen_off, _dropped
    with _LOCK:
        _session += 1
        _seen_off = False
        _RECORDS.clear()
        _dropped = 0
