"""Port parity: preemption/swap in the paged engine (repro_torch.serve).

Ports of the JAX suite's ``tests/test_serve.py`` preemption tests, each
run twice: inside the port (preempt equals reserve and the single-request
``decode_step`` path, token for token) and against the JAX engine on the
same converted weights and requests (tokens, the ``preemptions`` /
``resumes`` counters and the event timeline equal). f32 smoke TinyLlama
(2 layers, vocab 128): the greedy tokens are integers, so every comparison
is exact.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as JS  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE = dict(n_layers=2, vocab=128, param_dtype="float32",
             compute_dtype="float32")
COUNTERS = ("preemptions", "resumes", "spec_steps", "spec_drafted",
            "spec_accepted", "spec_disabled_groups")


@pytest.fixture(scope="module")
def served():
    jm = jbuild(jget("tinyllama_1_1b").smoke(**SMOKE))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("tinyllama_1_1b").smoke(**SMOKE)
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _prompts(seed, n, vocab=128, size=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=size).tolist() for _ in range(n)]


# (name) -> (engine kwargs, prompt seed, count, max_new_tokens), from
# tests/test_serve.py:406-454
SCENARIOS = {
    # 1-block prompts growing to 3 blocks each against a 4-page pool:
    # concurrent decode exhausts the pool and forces swaps
    "swap": (dict(num_slots=2, max_seq=32, block_size=8, num_blocks=4,
                  prefill_chunk=8, preempt=True), 13, 3, 12),
    # a 3-page pool fits one whole lifetime but two prompts
    "reserve3": (dict(num_slots=2, max_seq=32, block_size=8, num_blocks=3,
                      prefill_chunk=8), 17, 2, 12),
    "preempt3": (dict(num_slots=2, max_seq=32, block_size=8, num_blocks=3,
                      prefill_chunk=8, preempt=True), 17, 2, 12),
}


def _run(mod, served, name):
    jm, jp, tm, tp = served
    kw, seed, n, gen = SCENARIOS[name]
    reqs = [mod.Request(prompt=p, max_new_tokens=gen)
            for p in _prompts(seed, n)]
    if mod is JS:
        engine = JS.ServeEngine(jm, jp, JS.EngineConfig(**kw))
    else:
        engine = TS.ServeEngine(tm, tp, TS.EngineConfig(**kw), device="cpu")
    return engine, engine.run(reqs)


@pytest.fixture(scope="module")
def runs(served):
    """Each scenario once through each engine (the JAX runs compile)."""
    return {(mod.__name__, name): _run(mod, served, name)
            for mod in (JS, TS) for name in SCENARIOS}


def _decode_step_generate(model, params, prompt, max_new, max_seq=48):
    """The single-request path: a scalar-pos slot cache, one decode_step
    per prompt and generated token (the oracle batched serving matches)."""
    cache = model.init_cache(1, max_seq)
    toks = torch.tensor([prompt])
    with torch.no_grad():
        for t in range(len(prompt)):
            logits, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        out = [int(logits[0, -1].argmax())]
        while len(out) < max_new:
            logits, cache = model.decode_step(
                params, torch.tensor([[out[-1]]]), cache)
            out.append(int(logits[0, -1].argmax()))
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_engine(runs, name):
    _, j = runs[("repro.serve", name)]
    _, t = runs[("repro_torch.serve", name)]
    assert [s.output for s in t.completed] == [s.output for s in j.completed]
    assert [s.finish_reason for s in t.completed] == \
        [s.finish_reason for s in j.completed]
    assert [s.preemptions for s in t.completed] == \
        [s.preemptions for s in j.completed]
    for field in COUNTERS + ("peak_active_requests", "joined_mid_stream"):
        assert getattr(t, field) == getattr(j, field), field
    assert [(e["event"], e["request_id"], e["slot"], e.get("blocks"))
            for e in t.events] == \
        [(e["event"], e["request_id"], e["slot"], e.get("blocks"))
         for e in j.events]


def test_preempt_then_resume_token_identical(runs, served):
    """Under page exhaustion the preempting engine swaps a victim's pages
    to the host and resumes it later; greedy decode is unaffected."""
    _, _, tm, tp = served
    engine, report = runs[("repro_torch.serve", "swap")]
    assert report.preemptions >= 1 and report.resumes >= 1
    assert report.resumes == report.preemptions  # everyone came back
    kinds = {ev["event"] for ev in report.events}
    assert {"preempt", "resume"} <= kinds
    assert len(report.completed) == 3
    assert max(s.preemptions for s in report.completed) >= 1
    for state in report.completed:
        expected = _decode_step_generate(tm, tp, state.request.prompt, 12)
        assert state.output == expected, f"req {state.request_id} diverged"
    assert engine.pool.stats()["blocks_in_use"] == 0
    assert engine._swapped_blocks == 0


def test_preempt_sustains_higher_concurrency_than_reservation(runs):
    """Optimistic admission + swap serves >= 2x the concurrent requests of
    whole-lifetime reservation from the same pool, with the same tokens."""
    _, reserved = runs[("repro_torch.serve", "reserve3")]
    _, preempting = runs[("repro_torch.serve", "preempt3")]
    assert reserved.peak_active_requests == 1
    assert preempting.peak_active_requests >= 2 * \
        reserved.peak_active_requests
    ref = {tuple(s.request.prompt): s.output for s in reserved.completed}
    for state in preempting.completed:
        assert state.output == ref[tuple(state.request.prompt)]


def test_swap_restore_writes_only_mapped_pages(served):
    """The swap-in scatters a request's pages through its fresh table;
    entries past its written blocks go to the pool's sink cell, so no other
    page changes, and the restored pages equal the swapped-out ones."""
    _, _, tm, tp = served
    engine = TS.ServeEngine(tm, tp, TS.EngineConfig(
        num_slots=2, max_seq=32, block_size=8, num_blocks=4,
        prefill_chunk=8, preempt=True), device="cpu")
    state = engine.submit(TS.Request(prompt=list(range(1, 12)),
                                     max_new_tokens=4))
    group = engine.groups[None]
    while not state.output:       # prefill (two chunks), first token
        engine.tick()
    engine.tick()                 # one decode step: 12 cells written
    slot = state.slot
    old_table = [b for b in group.tables[slot] if b >= 0]
    cells = engine.kv["k"].shape[1] - 1
    written = torch.cat([torch.arange(b * 8, b * 8 + 8) for b in old_table])
    before = engine.kv["k"][:, written].clone()
    engine._preempt(group, slot, state)
    assert state.swap["k"].device.type == "cpu"
    engine.kv["k"][:, :cells] = -7.0   # every real cell overwritten
    engine.kv["k"][:, cells] = 0.0
    assert engine._admit_all(allow_preempt=True)
    new_table = [b for b in group.tables[state.slot] if b >= 0]
    restored = torch.cat([torch.arange(b * 8, b * 8 + 8)
                          for b in new_table[:len(old_table)]])
    assert torch.equal(engine.kv["k"][:, restored], before)
    others = torch.ones(cells, dtype=torch.bool)
    others[restored] = False
    assert bool((engine.kv["k"][:, :cells][:, others] == -7.0).all())
    assert engine._resumes == 1 and engine._swapped_blocks == 0


def test_undersized_swap_buffer_stalls_then_reports_livelock(served):
    """A swap buffer too small for any victim can never free a page: the
    engine stalls, then raises instead of spinning forever."""
    _, _, tm, tp = served
    engine = TS.ServeEngine(tm, tp, TS.EngineConfig(
        num_slots=2, max_seq=32, block_size=8, num_blocks=3,
        prefill_chunk=8, preempt=True, swap_blocks=1), device="cpu")
    engine._STUCK_TICKS = 20
    reqs = [TS.Request(prompt=p, max_new_tokens=20)
            for p in _prompts(5, 2, size=7)]
    with pytest.raises(RuntimeError, match="livelock"):
        engine.run(reqs)


def test_launcher_preempt_smoke_on_cpu(capsys):
    from repro_torch.launch import serve

    report = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device",
                         "cpu", "--layers", "2", "--slots", "4", "--blocks",
                         "8", "--block-size", "8", "--max-seq", "48",
                         "--preempt", "--poisson", "0.6", "--requests", "8",
                         "--gen", "14", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "SMOKE-OK" in out and "preemption(s) / " in out
    assert " preempt req " in out and " resume req " in out
    assert report.preemptions >= 1
    assert report.resumes == report.preemptions
    assert len(report.completed) == 8
