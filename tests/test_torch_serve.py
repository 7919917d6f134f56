"""Port parity: the paged continuous-batching engine (repro_torch.serve)
against the JAX engine on the same converted weights and requests."""
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
TIERS = (("free", "*=pc3_tr"), ("paid", "*/attn/*=exact,*=pc3_tr"))


@pytest.fixture(scope="module")
def served():
    jm = jbuild(jget("tinyllama_1_1b").smoke(**SMOKE))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("tinyllama_1_1b").smoke(**SMOKE)
    tm = tbuild(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _requests(mod):
    reqs = mod.synthetic_requests(6, 128, base_prompt=12, base_gen=6, seed=0,
                                  tiers=["free", "paid"])
    reqs[3].prompt = list(reqs[0].prompt)  # a repeated prefix, same tier
    reqs[3].policy = reqs[0].policy
    return reqs


ENGINE = dict(num_slots=2, max_seq=32, block_size=8, prefill_chunk=8,
              tiers=TIERS)


def test_engine_tokens_identical_to_jax_engine(served):
    jm, jp, tm, tp = served
    kw = ENGINE
    jrep = JS.ServeEngine(jm, jp, JS.EngineConfig(**kw)).run(_requests(JS))
    trep = TS.ServeEngine(tm, tp, TS.EngineConfig(**kw), device="cpu").run(
        _requests(TS))
    assert len(trep.completed) == len(jrep.completed) == 6
    for j, t in zip(jrep.completed, trep.completed):
        assert (t.request_id, t.group) == (j.request_id, j.group)
        assert t.output == j.output
        assert t.finish_reason == j.finish_reason
    assert trep.policy_groups == jrep.policy_groups == 2
    assert trep.prefix_hits == jrep.prefix_hits >= 1
    assert trep.joined_mid_stream == jrep.joined_mid_stream
    assert sum(trep.group_steps.values()) >= trep.decode_steps
    assert [(e["event"], e["request_id"], e["slot"]) for e in trep.events] == \
        [(e["event"], e["request_id"], e["slot"]) for e in jrep.events]


def test_sync_tick_loop_tokens_identical_to_async(served):
    _, _, tm, tp = served
    outs = []
    for overlap in (True, False):
        rep = TS.ServeEngine(tm, tp, TS.EngineConfig(**ENGINE, overlap=overlap),
                             device="cpu").run(_requests(TS))
        outs.append([st.output for st in rep.completed])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [
    dict(num_slots=0), dict(block_size=-1), dict(max_seq=40, block_size=16),
    dict(max_seq=16, prefill_chunk=32), dict(max_seq=96, prefill_chunk=12),
    dict(tiers=(("free", 3),)), dict(num_blocks=-1), dict(swap_blocks=-1),
    dict(spec_k=2), dict(spec_draft="free"), dict(spec_k=-1, spec_draft="f"),
    dict(max_seq=16, block_size=16, spec_k=16, spec_draft="f"),
    dict(spec_k=2, spec_draft="f", spec_min_accept=1.5),
])
def test_engine_config_errors_match(kw):
    with pytest.raises(ValueError) as jerr:
        JS.EngineConfig(**kw)
    with pytest.raises(ValueError) as terr:
        TS.EngineConfig(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw,field", [
    (dict(shards=2), "shards"),
])
def test_unported_engine_features_raise(served, kw, field):
    """``shards`` without a matching mesh: the reference's ValueError,
    word for word (tensor-parallel serving itself:
    tests/test_torch_parallel_serve.py)."""
    jm, jp, tm, tp = served
    with pytest.raises(ValueError, match=field) as jerr:
        JS.ServeEngine(jm, jp, JS.EngineConfig(num_slots=2, **kw))
    with pytest.raises(ValueError, match=field) as terr:
        TS.ServeEngine(tm, tp, TS.EngineConfig(num_slots=2, **kw),
                       device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_engine_rejects_windowed_model_and_bad_requests(served):
    _, _, tm, tp = served
    windowed = tget("tinyllama_1_1b").smoke(**SMOKE, window=8)
    with pytest.raises(ValueError, match="window"):
        TS.EngineConfig().validate_for_model(windowed)
    eng = TS.ServeEngine(tm, tp, TS.EngineConfig(num_slots=1, max_seq=16,
                                                 block_size=8), device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(TS.Request(prompt=[1] * 10, max_new_tokens=10))
    with pytest.raises(ValueError, match="unknown policy tier"):
        eng.submit(TS.Request(prompt=[1, 2], max_new_tokens=2, policy="gold"))


def test_engine_defaults_to_the_card(served):
    """ServeEngine(...) without device= runs on the card; on a machine
    without one it raises instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, _, tm, tp = served
    with pytest.raises(RuntimeError, match="cuda"):
        TS.ServeEngine(tm, tp, TS.EngineConfig(num_slots=1))


def test_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch import serve

    report = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device",
                         "cpu", "--layers", "2", "--tiers",
                         "free=*=pc3_tr:pallas;paid=*/attn/*=exact,"
                         "*=pc3_tr:pallas"])
    out = capsys.readouterr().out
    assert "SMOKE-OK: continuous batching" in out
    assert "SMOKE-OK: 2 policy groups" in out
    assert len(report.completed) == 6
