"""The port's spans and counters (``repro_torch.runtime.trace``): off
without a profiler, nested records with their attrs under one, and the
serving engine's spans tick by tick on a tiny model."""
import json
import re

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.workload import synthetic_requests  # noqa: E402

SMOKE = dict(n_layers=2, vocab=128, param_dtype="float32",
             compute_dtype="float32")
ENGINE = dict(num_slots=2, max_seq=32, block_size=8, prefill_chunk=8,
              tiers=(("free", "*=pc3_tr"), ("paid", "*/attn/*=exact")))


@pytest.fixture(autouse=True)
def _fresh_records():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def tiny():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    model = build_model(get_config("tinyllama_1_1b").smoke(**SMOKE),
                        device="cpu")
    yield model, model.init(0)
    torch.set_num_threads(n)


def _requests():
    return synthetic_requests(5, 128, base_prompt=11, base_gen=5, seed=3,
                              tiers=["free", "paid"])


def _engine(tiny):
    model, params = tiny
    return ServeEngine(model, params, EngineConfig(**ENGINE), device="cpu")


def _serve(tiny, plan=None):
    """Serve the requests tick by tick; ``plan`` (a list) gets each tick's
    real prefill tokens by group, counted before the tick."""
    engine = _engine(tiny)
    states = [engine.submit(r) for r in _requests()]
    while True:
        if plan is not None:
            chunk = engine.cfg.prefill_chunk
            plan.append({g.label: sum(
                min(chunk, len(st.request.prompt) - st.next_pos)
                for st in g.prefill_rows.values())
                for g in engine.groups.values() if g.prefill_rows})
        if not engine.tick():
            break
    return engine, states


def test_nothing_recorded_and_no_range_opened_without_a_profiler(
        tiny, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("a", x=1) is trace.span("b")
    with trace.timed("c") as sp:
        pass
    assert sp.end_ns >= sp.start_ns > 0
    engine, states = _serve(tiny)
    assert all(st.finish_time for st in states)
    assert engine._step_times and engine._idle_s > 0
    assert trace.records() == [] and opened == []


def test_records_nest_and_reach_the_chrome_trace(tmp_path):
    counts = {"n": 0}

    def counters():
        return dict(counts)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer", kind="x"):
            with trace.timed("mid", counters=counters) as sp:
                counts["n"] += 3
                with trace.span("inner", annotate=False):
                    torch.ones(4).sum()
            with trace.span("second"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    recs = trace.records()
    assert [(r.name, r.parent) for r in recs] == [
        ("outer", -1), ("mid", 0), ("inner", 1), ("second", 0)]
    assert recs[0].attrs == {"kind": "x"} and recs[1].attrs == {"n": 3}
    assert (recs[1].start_ns, recs[1].end_ns) == (sp.start_ns, sp.end_ns)
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
    assert recs[0].start_ns <= recs[1].start_ns <= recs[2].start_ns
    assert recs[2].end_ns <= recs[1].end_ns <= recs[3].start_ns
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"outer", "mid", "second"} <= names and "inner" not in names
    trace.clear()
    assert trace.records() == []


def test_records_are_the_latest_sessions_and_capped(monkeypatch):
    for name in ("first", "second"):
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span(name):
                pass
        with trace.span("between"):   # the profiler is off here
            pass
        assert [r.name for r in trace.records()] == [name]
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with trace.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("a"):
            for _ in range(4):
                with trace.span("b"):
                    with trace.span("c"):
                        pass
    assert [(r.name, r.parent) for r in trace.records()] == [
        ("a", -1), ("b", 0), ("c", 1)]
    assert trace.dropped() == 6
    assert all(r.end_ns >= r.start_ns > 0 for r in trace.records())
    trace.clear()
    assert trace.dropped() == 0


TICK = re.compile(r"B(L)*A(FP)*A")
SHORT = {"engine.blocks": "B", "engine.launch": "L", "engine.admit": "A",
         "engine.fetch": "F", "engine.apply": "P"}


def test_engine_spans_in_phase_order_and_prefill_counts(tiny):
    plan = []
    with profile(activities=[ProfilerActivity.CPU]):
        engine, states = _serve(tiny, plan)
    recs = trace.records()
    ticks = [i for i, r in enumerate(recs) if r.name == "engine.tick"]
    assert len(ticks) == engine.step == len(plan)
    for t, i in enumerate(ticks):
        assert recs[i].parent == -1 and recs[i].attrs == {"step": t}
        kids = [(j, r) for j, r in enumerate(recs) if r.parent == i]
        assert TICK.fullmatch("".join(SHORT[r.name] for _, r in kids))
        launched = [(j, r) for j, r in kids if r.name == "engine.launch"]
        assert len(launched) == sum(r.name == "engine.fetch" for _, r in kids)
        want = dict(plan[t])
        for j, r in launched:
            a = r.attrs
            assert a["kind"] in ("prefill", "decode")
            assert a["group"] in ("free", "paid") and a["request_ids"]
            assert set(trace.kernel_launches()) <= set(a)
            inner = [x.name for x in recs if x.parent == j]
            assert inner[0] == "engine.stage" and inner[1] == "model.embed"
            assert inner[2:-1] == ["model.attn", "model.ffn"] * 2
            assert inner[-1] == "model.lm_head"
            if a["kind"] == "prefill":
                assert a["positions"] == 2 * 8
                assert a["tokens"] == want.pop(a["group"])
            else:
                assert a["positions"] == 2 and a["tokens"] == len(
                    a["request_ids"])
        assert not want
    kinds = {r.attrs["kind"] for r in recs if r.name == "engine.launch"}
    assert kinds == {"prefill", "decode"}
    assert sum(sum(p.values()) for p in plan) == sum(
        len(st.request.prompt) for st in states)


def test_engine_clock_is_the_spans(tiny):
    with profile(activities=[ProfilerActivity.CPU]):
        engine, _ = _serve(tiny)
    recs = trace.records()
    steps, fetched = [], iter(r for r in recs if r.name == "engine.fetch")
    for r in recs:
        if r.name == "engine.launch":
            f = next(fetched)
            if r.attrs["kind"] != "prefill":
                steps.append((f.end_ns - r.start_ns) / 1e9)
    assert steps == engine._step_times
    idle = sum(r.end_ns - r.start_ns for r in recs if r.name == "engine.fetch")
    assert engine._idle_s == pytest.approx(idle / 1e9, rel=1e-9)


def test_tokens_identical_with_tracing_on_and_admit_time_in_order(tiny):
    _, off = _serve(tiny)
    with profile(activities=[ProfilerActivity.CPU]):
        _, on = _serve(tiny)
    assert trace.records()
    assert [st.output for st in on] == [st.output for st in off]
    for st in off + on:
        assert st.submit_time <= st.admit_time <= st.first_token_time
        assert st.first_token_time <= st.finish_time
