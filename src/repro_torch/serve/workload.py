"""Synthetic serving workloads.

Deterministic mixed-length request sets shared by the serve CLI, the
benchmark, and the example. Two arrival processes:

* :func:`synthetic_requests` — fixed ``arrival_every`` stagger (or all at
  once): the original trace-replay shape, convenient for token-identity
  tests because retirements never all land on the same step.
* :func:`poisson_requests` — a seeded Poisson arrival process (exponential
  inter-arrival gaps in *engine steps*, ``rate`` expected arrivals per
  step): the ROADMAP's serving-benchmark workload, what TTFT/latency
  percentiles should be quoted under.

Both accept ``tiers``: a sequence of policy selectors (tier names, specs,
``ApproxPolicy``, or None) sampled per request with the same seeded rng, so
mixed free/paid traffic is reproducible.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .scheduler import Request

# length stagger patterns (cycled): relative offsets around the base
_PROMPT_STAGGER = (0, 3, -2, 5, 1, -3, 4, 2)
_GEN_STAGGER = (0, -3, 2, 5, -2, 3, -1, 4)


def _lengths(i: int, base_prompt: int, base_gen: int):
    plen = max(2, base_prompt + _PROMPT_STAGGER[i % len(_PROMPT_STAGGER)])
    gen = max(2, base_gen + _GEN_STAGGER[i % len(_GEN_STAGGER)])
    return plen, gen


def _pick_tier(rng: np.random.Generator, tiers: Sequence):
    if not tiers:
        return None
    return tiers[int(rng.integers(0, len(tiers)))]


def synthetic_requests(n: int, vocab: int, *, base_prompt: int = 8,
                       base_gen: int = 8, seed: int = 0,
                       arrival_every: int = 0,
                       tiers: Sequence = ()) -> List[Request]:
    """``n`` requests with staggered lengths. ``arrival_every`` > 0 spaces
    arrivals that many engine steps apart (trace replay); 0 = all at once."""
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n):
        plen, gen = _lengths(i, base_prompt, base_gen)
        requests.append(Request(
            prompt=rng.integers(0, vocab, size=plen).tolist(),
            max_new_tokens=gen,
            arrival_step=i * arrival_every,
            policy=_pick_tier(rng, tiers)))
    return requests


def poisson_requests(n: int, vocab: int, *, rate: float = 0.5,
                     base_prompt: int = 8, base_gen: int = 8, seed: int = 0,
                     tiers: Sequence = (),
                     repeat_prompt_every: int = 0) -> List[Request]:
    """``n`` requests arriving by a seeded Poisson process.

    ``rate`` is the expected number of arrivals per engine step; arrival
    steps are the floored cumulative sum of exponential(1/rate) gaps, so
    bursts and lulls both occur (what p99 TTFT is for). Lengths follow the
    same stagger patterns as :func:`synthetic_requests`; token ids come
    from the seeded rng. ``repeat_prompt_every`` > 0 makes every k-th
    request reuse the previous prompt verbatim — a shared-prefix workload
    that exercises the engine's prefix cache."""
    if rate <= 0:
        raise ValueError(f"poisson rate must be > 0 (got {rate})")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    requests: List[Request] = []
    prev_prompt: Optional[List[int]] = None
    for i in range(n):
        plen, gen = _lengths(i, base_prompt, base_gen)
        if (repeat_prompt_every and prev_prompt is not None
                and i % repeat_prompt_every == 0):
            prompt = list(prev_prompt)
        else:
            prompt = rng.integers(0, vocab, size=plen).tolist()
        prev_prompt = prompt
        requests.append(Request(
            prompt=prompt, max_new_tokens=gen,
            arrival_step=int(arrivals[i]),
            policy=_pick_tier(rng, tiers)))
    return requests
