"""Training: ``build_artifacts(cfg).train_step`` with AdamW, the DAISM
product in the forward and in both backward GEMMs.

Set-up draws the weights (kept as they were drawn: the reference starts
from them) and ``check_steps + distinct_batches`` batches of bigram
tokens, builds the step and the optimizer state once, and drives that one
object through its first ``check_steps`` steps on distinct rows through
the window's own call and feed: the warm-up is those steps. It keeps each
step's loss, each leaf's first gradient as the optimizer took it (its
first moment after one step over ``1 - b1``) and each leaf's change after
the last of them. The window then runs whole steps (each synchronised)
until ``--seconds`` have passed; ``train_tok_s`` is their tokens over the
window. Once it has closed and the program's state is freed, the
reference trains a copy of the drawn weights through the same steps.
"""
from __future__ import annotations

import statistics
import time

import torch

from perfbench import harness, port, traffic, weights, work
from perfbench.reference import train as ref_train


def _leaf_norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in weights.flatten(tree).items()}


def _changes(tree, init) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float() - init[k].float()))
            for k, v in weights.flatten(tree).items()}


def leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms, over the larger of its reference norm
    and the median leaf's."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def faulty(step, fault):
    """The program's step with a fault planted (for the checks' tests):
    ``half_batch`` trains on the first half of the rows' tokens, the mean
    over the rest; ``unchanged`` returns the state as it was given."""
    if fault == "half_batch":
        def half(params, opt, batch):
            n = batch["tokens"].shape[1] // 2
            return step(params, opt, {k: v[:, :n] for k, v in batch.items()})
        return half
    if fault == "unchanged":
        def same(params, opt, batch):
            flat = weights.flatten(params)
            keep = ({k: v.clone() for k, v in flat.items()},
                    [(t, t.clone()) for tree in opt[1:]
                     for t in weights.flatten(tree).values()],
                    opt.step.clone())
            _, new, metrics = step(params, opt, batch)
            for k, v in flat.items():
                v.copy_(keep[0][k])
            for t, old in keep[1]:
                t.copy_(old)
            return params, new._replace(step=keep[2]), metrics
        return same
    return step


def gemm_bound_step(w, rows, sites) -> float:
    """Bounds of one step's DAISM GEMMs: each site forward (rows, K, N),
    its ``da`` (rows, N, K) and ``dw`` (K, rows, N)."""
    gemms = [(s, k, n) for s, k, n in work.decoder_layer_gemms(w)] * w[
        "n_layers"] + [work.lm_head_gemm(w)]
    return sum(work.gemm_bound_s(rows, k, n) + work.gemm_bound_s(rows, n, k)
               + work.gemm_bound_s(k, rows, n)
               for s, k, n in gemms if s in sites)


def run(cell, t_start: float, spans: harness.Spans, *, control=False,
        fault=None) -> dict:
    from repro_torch.launch.steps import build_artifacts

    wl, dev = cell.workload, cell.device
    w = port.widths(cell.config)
    b, s, nc = wl["batch"], wl["seq"], wl["check_steps"]
    with spans.span("setup.build"):
        art = build_artifacts(
            port.arch(cell.config, wl["policy"], wl.get("backward", "")),
            device=dev, warmup=wl["warmup"], total_steps=wl["total_steps"])
        params = weights.make_params(w, cell.seed, dev)
        init = {k: v.clone() for k, v in weights.flatten(params).items()}
        opt = art.init_opt(params)
        gen = traffic.lm_batches(w["vocab"], b, s, seed=cell.seed)
        batches = [{k: torch.from_numpy(v).long().to(dev)
                    for k, v in next(gen).items()}
                   for _ in range(nc + wl["distinct_batches"])]
        step = faulty(art.train_step, fault)
    losses = []
    with spans.span("setup.warmup"):
        for i in range(nc):
            params, opt, m = step(params, opt, batches[i])
            losses.append(float(m["loss"]))
            if i == 0:
                b1c = 1.0 - 0.9  # AdamWConfig().b1
                first = {k: v / b1c for k, v in _leaf_norms(opt.m).items()}
        moved = _changes(params, init)
        port.sync(dev)
    setup_s = time.time() - t_start

    ring = batches[nc:]
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        with spans.span("train.step"):
            params, opt, m = step(params, opt, ring[steps % len(ring)])
            port.sync(dev)
        steps += 1
    window_s = time.perf_counter() - t0
    pairs = b * work.causal_pairs(s)
    layer = {"window": {"seconds": window_s,
                        "flops": 3 * steps * work.decoder_flops(w, b * s,
                                                                pairs)}}
    if cell.trace:
        traced = {}
        t1 = time.perf_counter()
        with harness.traced(cell, spans, traced):
            with spans.span("train.step"):
                params, opt, m = step(params, opt, ring[steps % len(ring)])
        sites = [k for k, v in wl["reference"]["sites"].items()
                 if v == "approx"]
        layer.update(trace=traced["trace"], traced={
            "seconds": time.perf_counter() - t1,
            "gemm_bound_s": gemm_bound_step(w, b * s, sites)})
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del art, opt, params, m, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with spans.span("check.reference"):
        checks = check(cell, init, batches[:nc], losses, first, moved,
                       control=control)
    return {"metrics": {"train_tok_s": harness.rate(steps * b * s, window_s),
                        "setup_s": setup_s},
            "attempted": steps, "failed": 0, "checks": checks,
            "layer": layer, "memory_peak_bytes": memory}


def reference_run(cell, init, batches, *, lower=False, keep_every=1.0):
    """(losses, first gradient norms, changes) of the reference trained from
    the drawn weights through ``batches``."""
    wl = cell.workload
    num = ref_train.TrainNumerics(wl["reference"]["variant"],
                                  wl["reference"]["sites"], lower=lower)
    params = weights.unflatten({k: v.clone() for k, v in init.items()})
    losses, first = ref_train.train(
        params, port.widths(cell.config), batches, num, warmup=wl["warmup"],
        total=wl["total_steps"], keep_every=keep_every)
    return losses, first, _changes(params, init)


def check(cell, init, batches, losses, first, moved, *, control=False):
    """``grad_leaf_gap``: the worst leaf's gap of first-gradient norms;
    ``update_leaf_gap``: the worst leaf's gap of change norms after the
    checked steps, over the leaves whose reference gradient is not nought
    to rounding (at least a thousandth of the median leaf's)."""
    r_loss, r_first, r_moved = reference_run(cell, init, batches)
    if control:
        losses, first, moved = reference_run(cell, init, batches, lower=True)
    med = statistics.median(r_first.values())
    live = {k for k, v in r_first.items() if v >= 1e-3 * med}
    checks = harness.Checks(cell.workload["limits"])
    # each step's loss is not compared: it has no reading to hold it
    # against (the control and the faults read within 10x of sound runs;
    # PERF.md); it is printed beside the checks
    checks.notes["loss_rel"] = max(abs(a - r) / abs(r)
                                   for a, r in zip(losses, r_loss))
    checks.notes["leaves_left_out"] = len(r_first) - len(live)
    checks.add("grad_leaf_gap", leaf_gap(first, r_first))
    checks.add("update_leaf_gap", leaf_gap(moved, r_moved, live))
    return checks
