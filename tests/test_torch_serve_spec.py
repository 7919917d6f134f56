"""Port parity: self-speculative decoding in the paged engine
(repro_torch.serve), and the engine's per-group resolution report.

Ports of the JAX suite's ``tests/test_serve.py:494-638``, each run twice:
inside the port (speculative equals plain greedy decode, token for token)
and against the JAX engine on the same converted weights and requests
(tokens, the speculation counters, ``preemptions`` / ``resumes`` and the
report's (path, kind, config) rows equal). f32 smoke TinyLlama (2 layers,
vocab 128): greedy tokens are integers, so every comparison is exact.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as JS  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.policy import clear_log as jclear_log  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.policy import clear_log as tclear_log  # noqa: E402


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
SPEC_DRAFT = "*=pc3_tr"
MIXED_SPEC = "*/layer_0/*=exact,@lm_head=exact,*=pc3_tr"
TIERS = (("free", SPEC_DRAFT), ("paid", MIXED_SPEC))
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


def _burst(mod, seed=21, n=4, gen=18):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(0, 128, size=6).tolist(),
                        max_new_tokens=gen) for _ in range(n)]


def _tiered(mod):
    return mod.poisson_requests(8, 128, rate=0.5, base_prompt=7, base_gen=10,
                                seed=0, tiers=["free", "paid"])


SPEC = dict(spec_draft=SPEC_DRAFT, spec_k=3)
POOL4 = dict(num_slots=4, max_seq=32, block_size=8, num_blocks=4,
             prefill_chunk=8)
# name -> (engine kwargs, requests); from tests/test_serve.py:562-618
SCENARIOS = {
    "tiers-plain": (dict(num_slots=4, max_seq=48, block_size=8,
                         prefill_chunk=8, tiers=TIERS), _tiered),
    "tiers-spec": (dict(num_slots=4, max_seq=48, block_size=8,
                        prefill_chunk=8, tiers=TIERS, **SPEC), _tiered),
    "pool4-reserve": (POOL4, _burst),
    "pool4-spec-preempt": (dict(POOL4, preempt=True, **SPEC), _burst),
}


def _engine(mod, served, kw):
    jm, jp, tm, tp = served
    if mod is JS:
        return JS.ServeEngine(jm, jp, JS.EngineConfig(**kw))
    return TS.ServeEngine(tm, tp, TS.EngineConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def runs(served):
    """Each scenario once through each engine (the JAX runs compile).

    Both packages' resolution logs are cleared first: they are global per
    policy value, and another module in the same worker (the reference's
    tests/test_models.py runs every id's smoke model under the default
    exact policy, the ``base`` group's) would leave other models' sites in
    one package's log only."""
    jclear_log()
    tclear_log()
    out = {}
    for mod in (JS, TS):
        for name, (kw, reqs) in SCENARIOS.items():
            engine = _engine(mod, served, kw)
            out[(mod.__name__, name)] = (engine, engine.run(reqs(mod)))
    return out


def _report_rows(text):
    """(section, path, kind, config) of every site row of a
    resolution_report, in order."""
    rows, section = [], ""
    for line in text.splitlines():
        if line.startswith("== group"):
            section = line
        elif line.startswith("  ") and " mults " in line:
            path, kind, conf = line.split()[:3]
            rows.append((section, path, kind, conf))
    return rows


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_jax_engine(runs, name):
    je, j = runs[("repro.serve", name)]
    te, t = runs[("repro_torch.serve", name)]
    assert [s.output for s in t.completed] == [s.output for s in j.completed]
    assert [(s.request_id, s.group, s.finish_reason, s.spec_drafted,
             s.spec_accepted, s.preemptions) for s in t.completed] == \
        [(s.request_id, s.group, s.finish_reason, s.spec_drafted,
          s.spec_accepted, s.preemptions) for s in j.completed]
    for field in COUNTERS + ("policy_groups", "decode_steps"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.spec_accept_rate == j.spec_accept_rate
    assert t.spec_tokens_per_step == j.spec_tokens_per_step
    assert [(e["event"], e["request_id"], e["slot"]) for e in t.events] == \
        [(e["event"], e["request_id"], e["slot"]) for e in j.events]
    # the per-group site resolution: the same sites, kinds and configs (the
    # mults column is the last traced shape in JAX, the last executed one
    # here: a difference by design, ROADMAP C3)
    trows = _report_rows(te.resolution_report())
    assert trows and trows == _report_rows(je.resolution_report())


def test_spec_decode_token_identical_mixed_tiers(runs):
    """Speculative decode under mixed-tier Poisson traffic is token-
    identical to plain decode, and the draft tier's own group is
    ineligible (it would verify with the numerics it drafted with)."""
    _, plain = runs[("repro_torch.serve", "tiers-plain")]
    engine, spec = runs[("repro_torch.serve", "tiers-spec")]
    assert ([s.output for s in spec.completed]
            == [s.output for s in plain.completed])
    assert spec.spec_steps >= 1
    assert 0.0 <= spec.spec_accept_rate <= 1.0
    assert spec.spec_tokens_per_step >= 1.0  # bonus token floor
    by_label = {g.label: g.spec_on for g in engine.groups.values()}
    assert by_label == {"free": False, "paid": True}
    assert spec.group_draft_steps["free"] == 0
    assert spec.group_draft_steps["paid"] == 3 * spec.spec_steps
    assert any(s.spec_drafted > 0 for s in spec.completed)
    for s in spec.completed:
        assert 0 <= s.spec_accepted <= s.spec_drafted
        assert s.spec_drafted == 0 or s.group == "paid"
    assert "speculative: " in spec.summary()


def test_spec_decode_with_preemption_rolls_back_and_drains(runs):
    """Speculation + preemption: rejected-draft pages are truncated back to
    the pool, preempted rows resume, tokens stay identical to the plain
    reserve engine, and the pool drains to zero pages in use."""
    _, ref = runs[("repro_torch.serve", "pool4-reserve")]
    engine, report = runs[("repro_torch.serve", "pool4-spec-preempt")]
    assert report.preemptions >= 1 and report.resumes == report.preemptions
    assert report.spec_steps >= 1
    assert ([s.output for s in report.completed]
            == [s.output for s in ref.completed])
    assert engine.pool.stats()["blocks_in_use"] == 0  # no leaked pages


def test_failed_speculative_extend_caps_acceptance(served):
    """When the pool cannot cover a row's draft window, the verify's
    acceptance is capped at the row's page coverage: the capped runs still
    give plain greedy's tokens, and both engines cap alike."""
    seen = {}
    for mod in (JS, TS):
        engine = _engine(mod, served, dict(POOL4, preempt=True, **SPEC))
        capped = []
        apply = engine._apply

        def spy(rec, apply=apply, capped=capped):
            if rec["kind"] == "spec":
                for slot in rec["rows"]:
                    raw = int(rec["np_acc"][slot])
                    if rec["caps"][slot] < min(raw, 3):
                        capped.append((engine.step, slot, raw,
                                       rec["caps"][slot]))
            return apply(rec)

        engine._apply = spy
        report = engine.run(_burst(mod, seed=21, n=4, gen=18))
        seen[mod.__name__] = (capped, [s.output for s in report.completed])
    tcapped, tout = seen["repro_torch.serve"]
    jcapped, jout = seen["repro.serve"]
    assert tcapped, "no verify step was capped by its page coverage"
    assert tcapped == jcapped
    assert tout == jout
    reserve = _engine(TS, served, POOL4).run(_burst(TS, seed=21, n=4, gen=18))
    assert tout == [s.output for s in reserve.completed]


def test_paged_verify_step_accept_and_bonus_semantics(served):
    """paged_verify_step against the sequential S=1 oracle: correct drafts
    are accepted up to the first mismatch, and the verify logits at the
    last accepted position supply the bonus token."""
    _, _, model, params = served
    block_size, num_blocks = 8, 4
    rng = np.random.default_rng(23)
    prompt = rng.integers(0, 128, size=6).tolist()
    table = torch.arange(num_blocks, dtype=torch.int32)[None, :]

    def step(kv, tokens, pos):
        cache = dict(kv, block_tables=table,
                     pos=torch.tensor([pos], dtype=torch.int32))
        with torch.no_grad():
            return model.paged_step(params, torch.tensor([tokens]), cache,
                                    block_size=block_size)

    def fresh_prefill():
        kv = model.init_paged_cache(num_blocks, block_size)
        logits, kv = step(kv, prompt, 0)
        return int(logits[0, -1].argmax()), kv

    t1, kv = fresh_prefill()
    toks = [t1]
    for j in range(3):
        logits, kv = step(kv, [toks[-1]], len(prompt) + j)
        toks.append(int(logits[0, 0].argmax()))
    t1, t2, t3, t4 = toks

    def verify(drafts):
        _, kv = fresh_prefill()
        cache = dict(kv, block_tables=table,
                     pos=torch.tensor([len(prompt)], dtype=torch.int32))
        with torch.no_grad():
            greedy, n_acc, _ = model.paged_verify_step(
                params, torch.tensor([[t1] + drafts]), cache,
                block_size=block_size)
        return [int(t) for t in greedy[0]], int(n_acc[0])

    wrong = (t4 + 1) % 128
    greedy, n_acc = verify([t2, t3, wrong])
    assert greedy[:3] == [t2, t3, t4]  # per-position argmax == sequential
    assert n_acc == 2                  # third draft rejected
    assert greedy[:n_acc + 1] == [t2, t3, t4]
    _, n_acc = verify([t2, t3, t4])
    assert n_acc == 3                  # perfect drafts: all accepted
    _, n_acc = verify([(t2 + 1) % 128, t3, t4])
    assert n_acc == 0                  # first mismatch gates the rest


def test_spec_controller_disables_low_acceptance_group(served):
    """The EWMA controller shuts a group's speculation off after the warmup
    once acceptance sinks below spec_min_accept, emitting one spec_off
    event; the decision is permanent for the run. Same trajectory as the
    JAX engine's controller."""
    ewmas = {}
    for mod in (JS, TS):
        engine = _engine(mod, served, dict(num_slots=2, max_seq=48,
                                           spec_min_accept=0.9, **SPEC))
        group = engine._group_for(None)
        assert group.spec_on
        for _ in range(engine._SPEC_WARMUP):
            engine._update_spec_controller(group, [0.0, 0.1])
        assert group.spec_on is False
        offs = [ev for ev in engine.events if ev["event"] == "spec_off"]
        assert len(offs) == 1 and offs[0]["group"] == group.label
        engine._update_spec_controller(group, [1.0])
        assert group.spec_on is False
        ewmas[mod.__name__] = (group.spec_ewma, offs[0]["ewma"])
    assert ewmas["repro_torch.serve"] == ewmas["repro.serve"]


def test_draft_model_shares_the_parameter_tensors(served):
    """The draft model reads the engine's parameter tensors (no copy) and
    the draft key drops the tier's display name, so the ``free`` tier is
    the draft policy's group."""
    _, _, tm, tp = served
    engine = TS.ServeEngine(tm, tp, TS.EngineConfig(
        num_slots=2, max_seq=48, tiers=TIERS, spec_draft="free", spec_k=3),
        device="cpu")
    assert engine._spec_key.name == ""
    assert not engine._spec_eligible(engine._group_for(
        engine._resolve_policy("free")).policy)
    assert engine._group_for(engine._resolve_policy(SPEC_DRAFT)) is \
        engine._group_for(engine._resolve_policy("free"))
    assert engine._spec_eligible(engine._group_for(
        engine._resolve_policy("paid")).policy)
    assert engine._draft_model.cfg.approx_policy.name == "free"
    before = {id(t) for t in jax.tree.leaves(tp)}
    engine.run([TS.Request(prompt=[1, 2, 3], max_new_tokens=6,
                           policy="paid")])
    assert {id(t) for t in jax.tree.leaves(engine.params)} == before


def test_launcher_spec_smoke_on_cpu(capsys):
    from repro_torch.launch import serve

    report = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device",
                         "cpu", "--layers", "2", "--tiers",
                         "free=*=pc3_tr;paid=*/attn/*=exact,*=pc3_tr",
                         "--spec-draft", "free", "--spec-k", "3"])
    out = capsys.readouterr().out
    assert "SMOKE-OK: speculative decoding took" in out
    assert "== group paid ==" in out and "saves" in out
    assert report.spec_steps >= 1 and report.spec_tokens_per_step >= 1.0
