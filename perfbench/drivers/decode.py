"""Batch transcription: ``build_artifacts(cfg).decode_step`` over a slot
cache whose encoder states were filled at set-up.

Set-up draws the weights, ``batch`` clips of frame embeddings and a start
token a row, encodes the clips with the program's ``encode`` into the
cache's ``enc`` (work the traffic needs: a transcription's encoder pass),
and runs one decode step. The window decodes the rows greedily, a step at
a time (each synchronised), from position 0; when ``pos`` reaches the
decoder's context it starts again at 0 over the same clips. The window's
tokens over its seconds are the host's rate (``decode.window_tok_s``, per
layer). After the window, ``trace_steps`` steps from position 0 run under
the profiler: ``transcribe_device_tok_s`` is their tokens over the
seconds in which the device ran an operation, and with ``--trace 1`` the
per-layer metrics read the same segment. The set-up's encoder pass and
window step ``1 + seed % 3`` run under taps (``tap.py``); once the window
has closed, the reference recomputes each of their stages from the
program's own input to it (``stages.py``).
"""
from __future__ import annotations

import contextlib
import time

import torch

from perfbench import harness, port, stages, tap, weights, work


def run(cell, t_start: float, spans: harness.Spans, *, control=False,
        fault=None) -> dict:
    from repro_torch.launch.steps import build_artifacts

    wl, dev = cell.workload, cell.device
    w = port.widths(cell.config)
    b, ctx = wl["batch"], w["max_target"]
    with spans.span("setup.build"):
        art = build_artifacts(port.arch(cell.config, wl["policy"]),
                              device=dev)
        params = weights.make_params(w, cell.seed, dev)
        gen = weights.generator(cell.seed, dev)
        frames = torch.randn((b, w["enc_frames"], w["d_model"]), generator=gen,
                             device=dev, dtype=torch.bfloat16)
        toks = torch.empty((b, ctx + 1), dtype=torch.long, device=dev)
        toks[:, 0] = torch.randint(0, w["vocab"], (b,), generator=gen,
                                   device=dev)
        cache = art.init_cache(b, ctx)
    from repro_torch.models import transformer

    enc_calls, dec_calls, heads = [], [], []
    with spans.span("setup.encode"), torch.no_grad(), tap.record(
            transformer, "encoder_block", enc_calls):
        cache["enc"].copy_(art.model.encode(params, frames))
        port.sync(dev)
    with spans.span("setup.warmup"):
        _, cache = art.decode_step(params, toks[:, :1], cache)
        cache["pos"] = torch.zeros_like(cache["pos"])
        port.sync(dev)
    setup_s = time.time() - t_start

    check_at = 1 + cell.seed % 3
    checked = {}

    def step(pos, cache, taps=False):
        with contextlib.ExitStack() as stack:
            if taps:
                stack.enter_context(tap.record(
                    transformer, "encdec_decoder_block", dec_calls,
                    before=tap.cache_copy))
                stack.enter_context(tap.record(transformer, "unembed", heads,
                                               x_arg=1))
                checked["tokens"] = toks[:, pos:pos + 1].clone()
            with spans.span("decode.step"):
                logits, cache = art.decode_step(params, toks[:, pos:pos + 1],
                                                cache)
                toks[:, pos + 1] = logits[:, -1].argmax(-1)
                port.sync(dev)
        pos += 1
        if pos == ctx:
            cache["pos"] = torch.zeros_like(cache["pos"])
            pos = 0
        return pos, cache

    pos = steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds or steps <= check_at:
        pos, cache = step(pos, cache, taps=steps == check_at)
        steps += 1
    window_s = time.perf_counter() - t0
    layer = {"window": {"seconds": window_s, "tokens": b * steps,
                        "flops": sum(work.encdec_decode_flops(
                            w, b, b * (i % ctx + 1)) for i in range(steps))}}
    metrics = {"setup_s": setup_s}
    if dev.type == "cuda":
        # the same positions in every run: the device's time for a step
        # does not hang on where the window stopped
        cache["pos"] = torch.zeros_like(cache["pos"])
        pos, n, traced = 0, wl["trace_steps"], {}
        t1 = time.perf_counter()
        with harness.traced(cell, spans, traced):
            for _ in range(n):
                pos, cache = step(pos, cache)
        sites = wl["reference"]["sites"]
        approx = [s for s, m in sites.items() if m == "approx"]
        per_step = (w["n_layers"] * work.gemm_bound_rows(
            work.encdec_decode_gemms(w), b, approx)
            + work.gemm_bound_rows([work.lm_head_gemm(w)], b, approx))
        layer.update(trace=traced["trace"], traced={
            "seconds": time.perf_counter() - t1, "gemm_bound_s": n * per_step,
            "flops": sum(work.encdec_decode_flops(w, b, b * (i + 1))
                         for i in range(n))})
        if traced["trace"] is not None:
            metrics["transcribe_device_tok_s"] = harness.rate(
                b * n, traced["trace"].busy_s)
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del art, cache
    if fault == "alter_answer":
        heads[0]["out"][0] = heads[0]["out"][1]
    with spans.span("check.reference"):
        st = stages.whisper_step(cell, params, frames, enc_calls, dec_calls,
                                 heads[0], checked["tokens"], control=control)
    checks = harness.Checks(wl["limits"])
    checks.add("stage_rel_rms", st.worst)
    checks.add("head_row_err", st.head)
    return {"metrics": metrics,
            "attempted": steps, "failed": 0, "checks": checks,
            "layer": layer, "memory_peak_bytes": memory}

