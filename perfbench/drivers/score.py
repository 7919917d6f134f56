"""Scoring: ``build_artifacts(cfg).prefill_step`` over seeded token batches,
back to back, for the whole window.

Set-up draws the weights and ``distinct_batches`` batches of ``batch`` x
``seq`` bigram tokens, and runs one step (the only shape). The window
runs whole steps, each synchronised, until ``--seconds`` have passed;
``score_tok_s`` is all their tokens over the window. Step ``seed % 2``
runs under taps (``tap.py``) that keep each layer's input and output and
the lm_head's; once the window has closed and the program is freed, the
reference recomputes every stage from the program's own input to it.
"""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench import harness, port, stages, tap, traffic, weights, work


def gemm_bound(cell, w, rows) -> float:
    sites = [s for s, m in cell.workload["reference"]["sites"].items()
             if m == "approx"]
    return (w["n_layers"] * work.gemm_bound_rows(
        work.decoder_layer_gemms(w), rows, sites)
        + work.gemm_bound_rows([work.lm_head_gemm(w)], rows, sites))


def run(cell, t_start: float, spans: harness.Spans, *, control=False,
        fault=None) -> dict:
    from repro_torch.launch.steps import build_artifacts

    wl, dev = cell.workload, cell.device
    w = port.widths(cell.config)
    b, s, nb = wl["batch"], wl["seq"], wl["distinct_batches"]
    with spans.span("setup.build"):
        art = build_artifacts(port.arch(cell.config, wl["policy"]),
                              device=dev)
        params = weights.make_params(w, cell.seed, dev)
        gen = traffic.lm_batches(w["vocab"], b, s, seed=cell.seed)
        toks = torch.stack([torch.from_numpy(next(gen)["tokens"])
                            for _ in range(nb)]).long().to(dev)
    with spans.span("setup.warmup"):
        art.prefill_step(params, {"tokens": toks[0]})
        port.sync(dev)
    setup_s = time.time() - t_start

    from repro_torch.models import transformer

    keep = cell.seed % 2
    blocks, heads = [], []
    steps = 0
    t0 = time.perf_counter()
    while True:
        with contextlib.ExitStack() as taps:
            if steps == keep:
                taps.enter_context(tap.record(transformer, "decoder_block",
                                              blocks))
                taps.enter_context(tap.record(transformer, "unembed", heads,
                                              x_arg=1))
            with spans.span("score.step"):
                art.prefill_step(params, {"tokens": toks[steps % nb]})
                port.sync(dev)
        steps += 1
        if time.perf_counter() - t0 >= cell.seconds and steps > keep:
            break
    window_s = time.perf_counter() - t0
    tokens = steps * b * s
    pairs = b * work.causal_pairs(s)
    layer = {"window": {"seconds": window_s,
                        "flops": steps * work.decoder_flops(w, b * s, pairs)}}
    if cell.trace:
        traced = {}
        t1 = time.perf_counter()
        with harness.traced(cell, spans, traced):
            with spans.span("score.step"):
                art.prefill_step(params, {"tokens": toks[steps % nb]})
        layer.update(trace=traced["trace"], traced={
            "seconds": time.perf_counter() - t1,
            "gemm_bound_s": gemm_bound(cell, w, b * s),
            "flash_bound_s": (w["n_layers"] * work.flash_bound_s(w, b, s)
                              if wl["reference"]["flash"] else 0.0)})
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del art
    if fault == "alter_answer":
        out = heads[0]["out"]
        out[:, s // 2] = out[:, s // 2 - 1]
    with spans.span("check.reference"):
        st = stages.dense_step(cell, params, blocks, heads[0],
                               toks[keep % nb], wl["reference"]["sites"],
                               control=control)
    checks = harness.Checks(wl["limits"])
    checks.add("stage_rel_rms", st.worst)
    checks.add("head_row_err", st.head)
    return {"metrics": {"score_tok_s": harness.rate(tokens, window_s),
                        "setup_s": setup_s},
            "attempted": steps, "failed": 0, "checks": checks,
            "layer": layer, "memory_peak_bytes": memory}
