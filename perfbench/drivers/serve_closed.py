"""Serving under a closed loop: ``ServeEngine.submit`` / ``tick``.

``clients`` clients each keep one request in the engine and submit their
next (``traffic.closed_loop_plan``: a fixed set of lengths, one tier a
client, tokens from the seed) as soon as their last one completes. Set-up draws the weights, builds the engine with the
workload's tiers and serves one short request a tier to the end (every
group's prefill and decode shapes). The window ticks the engine until
``--seconds`` have passed; ``gen_tok_s`` is every token the engine
emitted in those ticks over the window, ``ttft_p90_ms`` the 90th
percentile over every request submitted in the window of the engine's
time to first token (from its ``submit``). After the window no request
is submitted and the engine runs until each has completed. From tick
``5 + seed % 10`` of the window on, the first prefill and the first
decode launch of each tier run under taps (``tap.py``); once the
engine is freed, the reference recomputes every stage of those launches
from the program's own input to it and its page pool as the launch found
it (``stages.py``), and every token a launch produced must be the argmax
of the program's own logits at the row's last position.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import harness, port, stages, tap, traffic, weights, work
from perfbench.reference import models


def account(engine, chunk: int) -> dict:
    """What the next tick computes, by group label: real prefill tokens and
    their causal pairs, decode rows and theirs (padding is no work)."""
    out = {}
    for g in engine.groups.values():
        pt = pp = dr = dp = 0
        for st in g.prefill_rows.values():
            n = min(chunk, len(st.request.prompt) - st.next_pos)
            pt += n
            pp += n * st.next_pos + n * (n + 1) // 2
        for st in g.decode_rows.values():
            dr += 1
            dp += st.seq_len + 1
        out[g.label] = (pt, pp, dr, dp)
    return out


class Loop:
    """The clients: each holds one request in the engine and sends its
    next (``plan[client]``, round and round) when that one completes."""

    def __init__(self, engine, plan):
        from repro_torch.serve.scheduler import Request

        self.Request = Request
        self.engine, self.plan = engine, plan
        self.sent = [0] * len(plan)
        self.requests = []           # (state, plan entry), in submit order
        self.active = [self.submit(c) for c in range(len(plan))]

    def submit(self, client: int):
        mine = self.plan[client]
        r = mine[self.sent[client] % len(mine)]
        self.sent[client] += 1
        st = self.engine.submit(self.Request(
            prompt=r["prompt"], max_new_tokens=r["max_new"], policy=r["tier"]))
        self.requests.append((st, r))
        return st

    def refill(self) -> None:
        for c, st in enumerate(self.active):
            if st.finish_time:
                self.active[c] = self.submit(c)


def _tick(engine, spans, chunk, acct):
    """One engine tick; adds what it computes to ``acct`` and returns
    that."""
    now = account(engine, chunk)
    for label, v in now.items():
        acct.setdefault(label, np.zeros(4, np.int64))
        acct[label] += np.asarray(v)
    with spans.span("serve.tick"):
        engine.tick()
    return now


def tick_bound(w, now: dict, sites: dict) -> float:
    """Summed roofline bounds of a tick's DAISM GEMM launches: each group's
    prefill and decode launch, at its real rows."""
    gemms = work.decoder_layer_gemms(w)
    bound = 0.0
    for label, (pt, _, dr, _) in now.items():
        for rows in (int(pt), int(dr)):
            bound += (w["n_layers"] * work.gemm_bound_rows(
                gemms, rows, sites[label])
                + work.gemm_bound_rows([work.lm_head_gemm(w)], rows,
                                       sites[label]))
    return bound


def run(cell, t_start: float, spans: harness.Spans, *, control=False,
        fault=None) -> dict:
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    wl, dev = cell.workload, cell.device
    w = port.widths(cell.config)
    tr = wl["traffic"]
    chunk = wl["engine"]["prefill_chunk"]
    with spans.span("setup.build"):
        model = build_model(port.arch(cell.config, wl["policy"]), device=dev)
        params = weights.make_params(w, cell.seed, dev)
        engine = ServeEngine(model, params, EngineConfig(
            tiers=tuple(wl["tiers"].items()), **wl["engine"]), device=dev)
        plan = traffic.closed_loop_plan(tr, w["vocab"], cell.seed)
    with spans.span("setup.warmup"):
        for tier in tr["tiers"]:
            engine.submit(Request(prompt=plan[0][0]["prompt"][:chunk + 1],
                                  max_new_tokens=2, policy=tier))
        while engine.tick():
            pass
        port.sync(dev)
    base_steps = len(engine._step_times)
    setup_s = time.time() - t_start

    from repro_torch.models import transformer
    from repro_torch.serve import engine as engine_mod

    acct: dict = {}
    launches: list = []
    first_tap = 5 + cell.seed % 10
    ticks = 0
    t0 = time.perf_counter()
    loop = Loop(engine, plan)
    while time.perf_counter() - t0 < cell.seconds or (
            not covered(wl, launches) and ticks < first_tap + 1000):
        with contextlib.ExitStack() as stack:
            if ticks >= first_tap and not covered(wl, launches):
                stack.enter_context(launch_taps(transformer, engine_mod,
                                                launches))
            _tick(engine, spans, chunk, acct)
        loop.refill()
        ticks += 1
    window_s = time.perf_counter() - t0
    in_window = list(loop.requests)
    tokens = sum(len(st.output) for st, _ in in_window)
    step_s = engine._step_times[base_steps:]
    flops = sum(work.decoder_flops(w, int(v[0] + v[2]), int(v[1] + v[3]))
                for v in acct.values())
    layer = {"window": {"seconds": window_s, "flops": flops},
             "engine": {"step_s": step_s}}
    if cell.trace:
        traced, tacct, bound = {}, {}, 0.0
        sites = {t: [s for s, m in wl["reference"]["tiers"][t].items()
                     if m == "approx"] for t in wl["tiers"]}
        t1 = time.perf_counter()
        with harness.traced(cell, spans, traced):
            for _ in range(wl["trace_ticks"]):
                bound += tick_bound(w, _tick(engine, spans, chunk, tacct),
                                    sites)
                loop.refill()
        layer.update(trace=traced["trace"], traced={
            "seconds": time.perf_counter() - t1, "gemm_bound_s": bound})
    with spans.span("serve.drain"):
        while engine.tick():
            pass
    ttft = [st.ttft_s for st, _ in in_window]
    layer["engine"]["prefill_s"] = [st.prefill_s for st, _ in in_window]
    failed = sum(1 for st, _ in in_window if not st.finish_time)
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del engine, model
    if fault == "alter_token":
        rec = launches[0]
        row = int(torch.nonzero(rec["rows"])[0])
        rec["tok"] = rec["tok"].clone()  # an inference tensor until cloned
        rec["tok"][row] = (rec["tok"][row] + 1) % w["vocab"]
    with spans.span("check.reference"):
        checks = check(cell, params, launches, control=control)
    return {"metrics": {"gen_tok_s": harness.rate(tokens, window_s),
                        "ttft_p90_ms": 1e3 * harness.percentile(ttft, 90),
                        "setup_s": setup_s},
            "attempted": len(in_window), "failed": failed, "checks": checks,
            "layer": layer, "memory_peak_bytes": memory}


def covered(wl: dict, launches: list) -> bool:
    """Whether each tier's prefill and decode launch has been tapped."""
    seen = {(r["tier"], r["kind"]) for r in launches}
    return all((t, k) in seen for t in wl["tiers"]
               for k in ("prefill", "decode"))


@contextlib.contextmanager
def launch_taps(transformer, engine_mod, launches: list):
    """Tap the first launch of each tier and kind (prefill, decode): the
    ``group_step`` call with the layer calls (and each layer's page pool
    as it stood) and the lm_head call inside it."""
    orig = engine_mod.group_step

    def wrapped(model, params, kv, tokens, tables, pos, last_idx, **kw):
        tier = model.cfg.approx_policy.name
        kind = "prefill" if tokens.shape[1] > 1 else "decode"
        if any((r["tier"], r["kind"]) == (tier, kind) for r in launches):
            return orig(model, params, kv, tokens, tables, pos, last_idx,
                        **kw)
        blocks, heads = [], []
        with tap.record(transformer, "decoder_block", blocks,
                        before=tap.cache_copy), \
                tap.record(transformer, "unembed", heads, x_arg=1):
            tok = orig(model, params, kv, tokens, tables, pos, last_idx, **kw)
        launches.append({
            "tier": tier, "kind": kind, "tokens": tokens.clone(), "last_idx": last_idx.clone(),
            "rows": (tables >= 0).any(1), "tok": tok.clone(),
            "blocks": blocks, "head": heads[0]})
        return tok

    engine_mod.group_step = wrapped
    try:
        yield
    finally:
        engine_mod.group_step = orig


def check(cell, params, launches, *, control=False):
    """``stage_rel_rms`` and ``head_row_err`` over the tapped launches'
    real rows (``stages.py``); ``token_mismatch``: tokens a launch produced
    that are not the argmax of its own logits at the row's last position
    (an exact comparison)."""
    w = port.widths(cell.config)
    tiers = cell.workload["reference"]["tiers"]
    worst = head = 0.0
    mismatch = 0
    for rec in launches:
        def attention(c, n):
            cache = c["kw"]["cache"]
            return models.paged_attention(
                w, c["kw"]["positions"], cache["write_idx"],
                cache["phys_read"], c["before"]["k"], c["before"]["v"])
        st = stages.dense_step(cell, params, rec["blocks"], rec["head"],
                               rec["tokens"], tiers[rec["tier"]],
                               control=control, attention=attention,
                               rows=rec["rows"])
        worst, head = max(worst, st.worst), max(head, st.head)
        logits = rec["head"]["out"]
        idx = rec["last_idx"].long()
        best = logits[torch.arange(len(idx), device=idx.device), idx].argmax(-1)
        mismatch += int(((best != rec["tok"]) & rec["rows"]).sum())
    checks = harness.Checks(cell.workload["limits"])
    checks.add("stage_rel_rms", worst)
    checks.add("head_row_err", head)
    checks.add("token_mismatch", mismatch)
    return checks
