"""Taps on the program's layer calls, for the stage-by-stage check.

The DAISM product is a jagged function of its operands: a one-ulp change
of an input moves a product by up to a few per cent. Two correct
implementations that only add their f32 sums in another order therefore
drift apart layer by layer, to ~5% of the logits after four StarCoder2
layers and of the encoder states after 32 Whisper layers (``PERF.md``).
So the reference follows the program stage by stage from the program's
own state: each layer from the input the program gave that layer, the
head from the program's last hidden state, and the start (the embedding
lookup) by itself.

:func:`record` wraps a module-level function of the program for the
duration of one checked step and keeps, for every call, the input
activations, the output, the keyword arguments and, where the call reads
a cache, a copy of the cache taken before the call (``before``). The
wrapper is in place only for that step.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional


@contextlib.contextmanager
def record(module, name: str, calls: List[dict], x_arg: int = 2,
           before: Optional[Callable] = None):
    """Keep every call of ``module.name(*args, **kw)`` in ``calls``:
    ``{"args", "x" (a copy of ``args[x_arg]``), "out" (a copy of the
    result, or of its first element), "kw", "before"}``."""
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        pre = before(kw) if before is not None else None
        out = orig(*args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        calls.append({"args": args, "x": args[x_arg].detach().clone(),
                      "out": first.detach().clone(), "kw": kw,
                      "before": pre})
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def cache_copy(kw: dict):
    """A copy of the layer's cache tensors ``k`` and ``v`` before a call."""
    cache = kw.get("cache")
    if cache is None:
        return None
    return {k: cache[k].detach().clone() for k in ("k", "v")}
