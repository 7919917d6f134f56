"""Port parity: tensor-parallel paged serving (``ServeEngine(...,
mesh=...)``) on 4 ``gloo`` ranks against the JAX engine on 4 fake host
devices.

The reference runs in a subprocess (4 devices are fixed at its first jax
import) on a directly built ``jax.sharding.Mesh``, whose axes are Auto
(``jax.make_mesh`` makes Explicit axes, which the reference's sharding
constraints refuse). It saves its weights; the port's 4 ranks load them
(``tests/torch_ranks.py``, spawned by ``repro_torch.launch.mesh.run_ranks``
with one torch thread each and a deadline, so a deadlock fails the test).

Claims, on the f32 TinyLlama smoke config of
``tests/test_serve_multidevice.py`` (mixed tiers with Poisson arrivals,
preemption, speculation with preemption): the same ``{request_id:
output}`` as the reference's sharded engine, and the same preemptions,
resumes, speculative steps and shards. On the Qwen3-MoE smoke config the
MoE layers run expert-parallel with capacity dropping, so the oracle is
the reference's sharded run, not its dense engine: tokens equal, and the
resolution report equal (dense sites at their global shapes, expert sites
at their per-shard (E/n, capacity) shapes).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as JS  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402

import torch_ranks  # noqa: E402

TP_CFG = dict(n_layers=2, vocab=128, window=0, kv_heads=4,
              compute_dtype="float32", param_dtype="float32")
MOE_CFG = dict(n_layers=2, vocab=128, kv_heads=4, compute_dtype="float32",
               param_dtype="float32")
MOE_POLICY = "*/attn/*=exact,*=pc3_tr"
MOE_ENGINE = dict(num_slots=4, max_seq=32, block_size=8, prefill_chunk=8)
# (prompt, max_new_tokens, arrival_step)
MOE_REQS = [([int(t) for t in np.random.default_rng(i).integers(0, 128, n)],
             g, a) for i, (n, g, a) in enumerate(
                 [(10, 6, 0), (7, 8, 0), (12, 5, 1), (5, 7, 2), (9, 6, 3)])]
# one prefill chunk and no decode: one shape per site in both logs
REPORT_REQS = [([int(t) for t in np.random.default_rng(9).integers(0, 128, 8)],
                1, 0)]

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.serve import (EngineConfig, Request, ServeEngine,
                             poisson_requests)
    sys.path.insert(0, os.path.dirname(sys.argv[2]))
    import torch_ranks as R

    out_dir, _, spec = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    assert jax.device_count() == 4, jax.devices()
    mesh = Mesh(np.array(jax.devices()).reshape(4), ("model",))

    def flat(tree, pre=""):
        for k, v in tree.items():
            p = pre + "/" + k if pre else k
            if isinstance(v, dict):
                yield from flat(v, p)
            else:
                yield p, np.asarray(v)

    def serve(model, params, kw, reqs, sharded):
        eng = ServeEngine(model, params, EngineConfig(
            shards=4 if sharded else 1, **kw),
            mesh=mesh if sharded else None)
        rep = eng.run([Request(prompt=list(r.prompt),
                               max_new_tokens=r.max_new_tokens,
                               arrival_step=r.arrival_step, policy=r.policy)
                       for r in reqs])
        return dict(outputs={s.request_id: s.output for s in rep.completed},
                    preemptions=rep.preemptions, resumes=rep.resumes,
                    spec_steps=rep.spec_steps, shards=rep.shards,
                    blocks_in_use=eng.pool.stats()["blocks_in_use"],
                    report=eng.resolution_report())

    res = {}
    cfg = get_config("tinyllama_1_1b").smoke(**spec["tp_cfg"])
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    np.savez(os.path.join(out_dir, "tp.npz"), **dict(flat(params)))
    for name, sc in R.SCENARIOS.items():
        reqs = poisson_requests(6, cfg.vocab, base_prompt=7,
                                tiers=["free", "paid"], **sc["reqs"])
        kw = {k: v for k, v in sc["engine"].items()}
        res[name] = serve(model, params, kw, reqs, True)

    cfg = get_config("qwen3_moe_235b").smoke(**spec["moe_cfg"]).with_policy(
        spec["moe_policy"])
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(1))
    np.savez(os.path.join(out_dir, "moe.npz"), **dict(flat(params)))
    for name, reqs, twin in (("moe", spec["moe_reqs"], False),
                             ("moe-report", spec["report_reqs"], True)):
        reqs = [Request(prompt=p, max_new_tokens=n, arrival_step=a)
                for p, n, a in reqs]
        res[name] = serve(model, params, spec["moe_engine"], reqs, True)
        if twin:
            res[name + "-unsharded"] = serve(model, params,
                                             spec["moe_engine"], reqs, False)
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(res, f)
    print("REFERENCE-OK")
""")


def _outputs(d):
    return {int(k): list(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX engine's sharded runs (and the unsharded twin of the report
    run) on 4 fake host devices, with the weights they used."""
    out = tmp_path_factory.mktemp("ref")
    spec = dict(tp_cfg=TP_CFG, moe_cfg=MOE_CFG, moe_policy=MOE_POLICY,
                moe_engine=MOE_ENGINE, moe_reqs=MOE_REQS,
                report_reqs=REPORT_REQS)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out), torch_ranks.__file__,
         json.dumps(spec)], env=env, capture_output=True, text=True,
        timeout=400)
    assert "REFERENCE-OK" in proc.stdout, proc.stderr[-3000:]
    with open(out / "ref.json") as f:
        return out, json.load(f)


@pytest.fixture(scope="module")
def port(reference):
    """The port's runs of the same scenarios, on 4 gloo ranks: the TP
    scenarios in one group, the MoE id in another."""
    out, _ = reference
    tp = run_ranks(torch_ranks.tp_scenarios, 4, str(out / "tp.npz"), TP_CFG,
                   tuple(torch_ranks.SCENARIOS), timeout_s=300)
    moe = run_ranks(torch_ranks.moe_serve, 4, str(out / "moe.npz"), MOE_CFG,
                    MOE_POLICY, MOE_ENGINE,
                    {"moe": MOE_REQS, "moe-report": REPORT_REQS}, 4,
                    timeout_s=300)
    return tp, moe


@pytest.mark.parametrize("name", ["mixed", "preempt", "spec"])
def test_sharded_engine_matches_the_reference_sharded_engine(reference, port,
                                                             name):
    """Every rank: the reference's sharded tokens, counters and shards."""
    _, ref = reference
    want = ref[name]
    for rank_out in port[0]:
        got = rank_out[name]
        assert _outputs(got["outputs"]) == _outputs(want["outputs"])
        for key in ("preemptions", "resumes", "spec_steps", "shards",
                    "blocks_in_use"):
            assert got[key] == want[key], key
    assert want["shards"] == 4
    if name != "mixed":
        assert want["preemptions"] >= 1
    if name == "spec":
        assert want["spec_steps"] >= 1


def test_moe_served_expert_parallel_matches_the_reference(reference, port):
    """Qwen3-MoE on 4 shards (EP, capacity dropping): the reference's
    sharded tokens on every rank."""
    _, ref = reference
    for rank_out in port[1]:
        assert _outputs(rank_out["moe"]["outputs"]) == _outputs(
            ref["moe"]["outputs"])
        assert rank_out["moe"]["shards"] == 4


def test_moe_sharded_resolution_report_equals_the_reference(reference, port):
    """After one prefill chunk: dense sites at their global (M, K, N),
    expert sites at (E/n, capacity, d, f) per shard, as the reference's
    report under a mesh; and not the unsharded report's expert rows."""
    _, ref = reference
    got = port[1][0]["moe-report"]["report"]
    assert got == ref["moe-report"]["report"]
    assert "moe_expert" in got
    assert got != ref["moe-report-unsharded"]["report"]


@pytest.fixture(scope="module")
def smoke_model():
    cfg = dict(TP_CFG)
    jm = jbuild(jget("tinyllama_1_1b").smoke(**cfg))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("tinyllama_1_1b").smoke(**cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tbuild(tcfg, device="cpu"), tp


@pytest.mark.parametrize("kw", [
    dict(num_slots=3, max_seq=48, block_size=8, prefill_chunk=8, shards=4),
    dict(num_slots=4, max_seq=48, block_size=8, num_blocks=6,
         prefill_chunk=8, shards=4),
])
def test_indivisible_layout_refused_with_srv007(smoke_model, kw):
    """blocks / num_slots that the model axis does not divide: the
    reference's error text, naming SRV007 (the check runs before any
    collective, so a sizes-only mesh stands in for the group)."""
    _, _, tm, tp = smoke_model
    with pytest.raises(ValueError) as err:
        TS.ServeEngine(tm, tp, TS.EngineConfig(**kw), mesh={"model": 4},
                       device="cpu")
    assert "divisible" in str(err.value) and "SRV007" in str(err.value)


def test_shards_without_a_matching_mesh_raise_as_the_reference(smoke_model):
    jm, jp, tm, tp = smoke_model
    for mesh in (None, {"model": 2}):
        with pytest.raises(ValueError) as terr:
            TS.ServeEngine(tm, tp, TS.EngineConfig(num_slots=4, shards=4),
                           mesh=mesh, device="cpu")
        if mesh is None:
            with pytest.raises(ValueError) as jerr:
                JS.ServeEngine(jm, jp, JS.EngineConfig(num_slots=4, shards=4))
            assert str(terr.value) == str(jerr.value)
        assert "mesh" in str(terr.value)


def test_kv_heads_the_model_axis_does_not_divide_are_refused():
    """2 kv heads on a 4-way model axis: the reference replicates the pool
    (its head-local shard_map does not apply); the port refuses, naming the
    divisibility (ROADMAP.md C3)."""
    cfg = tget("tinyllama_1_1b").smoke(n_layers=2, vocab=128, window=0)
    assert cfg.kv_heads == 2
    m = tbuild(cfg, device="cpu")
    with pytest.raises(ValueError, match="kv_heads=2 must both be divisible"):
        TS.ServeEngine(m, m.init(0), TS.EngineConfig(num_slots=4, shards=4),
                       mesh={"model": 4}, device="cpu")


def test_launcher_serves_tensor_parallel_on_cpu_ranks(capfd):
    """``--shards 2 --device cpu`` spawns two gloo ranks; rank 0 prints
    the reference's gate line and returns every request's output."""
    from repro_torch.launch import serve

    outs = serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device",
                       "cpu", "--shards", "2", "--no-preflight"])
    out = capfd.readouterr().out
    assert "SMOKE-OK: served tensor-parallel over 2 shards" in out
    assert "SMOKE-OK: continuous batching" in out
    assert sorted(outs) == list(range(6))
    with pytest.raises(SystemExit, match="does not divide the 3 available"):
        serve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
                    "--shards", "2", "--devices", "3"])
