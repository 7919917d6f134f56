"""Traffic generation from a seed, read by every driver kind.

* :func:`lm_batches`: token streams from a fixed random bigram automaton
  with noise (a frozen copy of the program's ``data/synthetic.py``
  generator, so a change there never changes the benchmark's inputs).
* :func:`closed_loop_plan`: the requests of a closed-loop serving cell,
  client by client. The lengths are a stratified grid over the workload's
  uniform ranges in one fixed order and each client keeps one tier; the
  seed draws the tokens only, so every seed gives the same work.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, (vocab, 4))
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        for t in range(seq):
            choice = succ[toks[:, t], rng.integers(0, 4, batch)]
            noise = rng.integers(0, vocab, batch)
            use_noise = rng.random(batch) < 0.1
            toks[:, t + 1] = np.where(use_noise, noise, choice)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def token_stream(vocab: int, n: int, seed: int) -> np.ndarray:
    """``n`` tokens of one bigram stream."""
    return next(lm_batches(vocab, 1, n, seed=seed))["tokens"][0]


def _grid(lo: int, hi: int, n: int) -> List[int]:
    """``n`` lengths spread evenly over [lo, hi] (inclusive)."""
    return [lo + int((i + 0.5) * (hi - lo + 1) / n) for i in range(n)]


def closed_loop_plan(traffic: dict, vocab: int, seed: int) -> List[List[dict]]:
    """Each client's requests ``{prompt, max_new, tier}``, in the order the
    client sends them (round and round): ``per_client`` each, their
    lengths a stratified grid over the workload's uniform ``prompt`` and
    ``output`` ranges ([lo, hi] tokens) dealt out in one fixed order, the
    client's tier fixed (``tiers`` in turn, equal shares). Only the tokens
    come from ``seed``: every seed gives the same work, so the window's
    rate and tail do not change with it."""
    c, n = traffic["clients"], traffic["per_client"]
    prompts = _grid(*traffic["prompt"], c * n)
    outputs = _grid(*traffic["output"], c * n)
    fixed = np.random.default_rng(0)
    prompts = [prompts[i] for i in fixed.permutation(c * n)]
    outputs = [outputs[i] for i in fixed.permutation(c * n)]
    toks = token_stream(vocab, sum(prompts), seed)
    plan, off = [[] for _ in range(c)], 0
    for i in range(c * n):
        client = i % c
        plan[client].append({
            "prompt": toks[off:off + prompts[i]].tolist(),
            "max_new": outputs[i],
            "tier": traffic["tiers"][client % len(traffic["tiers"])]})
        off += prompts[i]
    return plan
