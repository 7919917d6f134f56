"""The port's checkpoints, fault-tolerant loop and training launcher.

* tests/test_checkpoint.py's five cases, on the port's ``checkpoint``;
* checkpoints cross between the packages in both directions, bit for bit,
  bf16 leaves included (bf16 is stored as ``|V2`` bits by both);
* tests/test_system.py's resume and straggler cases, on the port's loop;
* the loss sequence across a ``SimulatedPreemption`` against the JAX
  package's ``run`` on the same weights and batches, within
  tests/test_torch_train.py's train-step bounds (``TRAIN_TOL``);
* ``python -m repro_torch.launch.train`` on the CPU: it resumes, and on
  4 ``gloo`` ranks (``--devices 4``, ``--mesh 2x2``) its losses are the
  one-device run's within bf16 summation order;
* ``restore(shardings=)`` keeps a rank's shard of each stored array.
"""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.optim as jopt  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.launch.steps import build_artifacts as jbuild_artifacts  # noqa: E402
from repro.policy import ApproxPolicy as JPolicy  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import DaismConfig, Variant  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.module import flatten, unflatten  # noqa: E402
from repro_torch.models.registry import build_model, lm_loss  # noqa: E402
from repro_torch.optim import (AdamWConfig, AdamWState, apply_updates,  # noqa: E402
                               init_state)
from repro_torch.policy import ApproxPolicy  # noqa: E402
from repro_torch.runtime.fault_tolerance import (SimulatedPreemption,  # noqa: E402
                                                 TrainLoopConfig, run)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(t):
    return list(flatten(t).values())


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path, tree):
    ckpt.save(str(tmp_path), 3, tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore(str(tmp_path), 3, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert torch.equal(a, b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.data_ptr() != b.data_ptr()  # fresh memory


def test_incomplete_checkpoint_ignored(tmp_path, tree):
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    # simulate a crash mid-write on step 2: delete the sentinel
    os.remove(str(tmp_path / "step_00000002" / ckpt.SENTINEL))
    assert ckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), 2, tree)


def test_missing_key_detected(tmp_path, tree):
    ckpt.save(str(tmp_path), 1, tree)
    bigger = dict(tree, extra=torch.zeros((2,)))
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, bigger)


def test_cleanup_keeps_newest(tmp_path, tree):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree)
    ckpt.cleanup(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    remaining = sorted(os.listdir(tmp_path))
    assert remaining == ["step_00000004", "step_00000005"]


def test_overwrite_same_step(tmp_path, tree):
    ckpt.save(str(tmp_path), 1, tree)
    tree2 = {"a": tree["a"] * 0, "nested": {k: v * 0 for k, v in
                                            tree["nested"].items()}}
    ckpt.save(str(tmp_path), 1, tree2)
    out = ckpt.restore(str(tmp_path), 1, tree)
    assert float(out["a"].sum()) == 0.0


# ---------------------------------------------------------------------------
# between the packages
# ---------------------------------------------------------------------------


def _jax_train_state():
    """A JAX {"params", "opt"} tree of the bf16 smoke TinyLlama (bf16
    params, f32 norm scales and AdamW state, an int32 step), after one
    update so that no moment is zero."""
    model_cfg = jget("tinyllama_1_1b").smoke(n_layers=2, vocab=64)
    from repro.models.registry import build_model as jbuild

    params, _ = jbuild(model_cfg).init(jax.random.PRNGKey(0))
    opt = jopt.init_state(params)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, p.dtype), params)
    params, opt, _ = jopt.apply_updates(params, grads, opt,
                                        jopt.AdamWConfig(lr=1e-2))
    return {"params": params, "opt": opt}


def _port_like(jtree):
    """The port's tree of the same structure (params, AdamWState) and
    dtypes, holding other values."""
    cfg = tget("tinyllama_1_1b").smoke(n_layers=2, vocab=64)
    params = build_model(cfg, device="cpu").init(1)
    return {"params": params, "opt": init_state(params)}


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 as its 16 bits), for bit-for-bit checks."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    return np.asarray(x).tobytes()


def _jflat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jtree = _jax_train_state()
    jckpt.save(str(tmp_path), 5, jtree)
    like = _port_like(jtree)
    out = ckpt.restore(str(tmp_path), 5, like)
    assert isinstance(out["opt"], AdamWState)
    assert out["opt"].step.dtype == torch.int32 and out["opt"].step.dim() == 0
    jflat, tflat = _jflat(jtree), ckpt._flatten(out)
    assert set(jflat) == set(tflat)
    assert "opt/.step" in tflat and "opt/.master/blocks/attn/wq" in tflat
    for key, ref in jflat.items():
        got = tflat[key]
        assert str(got.dtype).replace("torch.", "") == np.asarray(
            ref).dtype.name, key
        assert _bits(got) == _bits(ref), key
    assert any(t.dtype == torch.bfloat16 for t in tflat.values())


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    """The JAX state carried into the port (the test above), saved by the
    port and restored by the JAX package: every leaf's bits, and the
    meta.json (keys, sha256 digest) of the JAX package's own save."""
    jtree = _jax_train_state()
    jpath = jckpt.save(str(tmp_path / "jax"), 7, jtree)
    src = ckpt.restore(str(tmp_path / "jax"), 7, _port_like(jtree))
    path = ckpt.save(str(tmp_path / "port"), 7, src)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["params/blocks/attn/wq"].dtype == np.dtype("V2")
        assert data["opt/.step"].dtype == np.int32
    out = jckpt.restore(str(tmp_path / "port"), 7, jtree)
    jflat = _jflat(jtree)
    for key, got in _jflat(out).items():
        assert np.asarray(got).dtype == np.asarray(jflat[key]).dtype, key
        assert _bits(got) == _bits(jflat[key]), key
    metas = [json.load(open(os.path.join(p, "meta.json")))
             for p in (path, jpath)]
    assert metas[0] == metas[1]


def test_restore_refuses_shardings(tmp_path, tree):
    """(Named when the port had no mesh and refused ``shardings``.) The
    whole tree saved, restored with the layout of a 2x2 mesh at each
    rank's coordinates: each leaf is that rank's slice of the stored
    array, bit for bit; a shard shape the tree does not hold raises."""
    from repro_torch.parallel.sharding import NamedSharding, Sharder

    ckpt.save(str(tmp_path), 1, tree)

    class At(Sharder):  # a sizes-only 2x2 mesh seen from one rank
        def __init__(self, coords):
            super().__init__({"data": 2, "model": 2}, {})
            self._at = coords

        def coords(self):
            return self._at

    for d in (0, 1):
        for m in (0, 1):
            sh = At({"data": d, "model": m})
            lay = {"a": NamedSharding(sh, ("data",)),
                   "nested": {"b": NamedSharding(sh, ("model",)),
                              "step": NamedSharding(sh, ())}}
            like = {"a": torch.zeros((1, 3)),
                    "nested": {"b": torch.zeros((2,), dtype=torch.bfloat16),
                               "step": torch.tensor(0, dtype=torch.int32)}}
            out = ckpt.restore(str(tmp_path), 1, like, shardings=lay)
            assert torch.equal(out["a"], tree["a"][d:d + 1])
            assert torch.equal(out["nested"]["b"],
                               tree["nested"]["b"][2 * m:2 * m + 2])
            assert out["nested"]["b"].dtype == torch.bfloat16
            assert torch.equal(out["nested"]["step"], tree["nested"]["step"])
    with pytest.raises(ValueError, match="shard"):
        ckpt.restore(str(tmp_path), 1, tree, shardings=lay)


# ---------------------------------------------------------------------------
# tests/test_system.py's loop cases on the port
# ---------------------------------------------------------------------------


def _make_step(model, ocfg):
    def step(params, opt, batch):
        batch = {k: torch.as_tensor(v).long() for k, v in batch.items()}
        leaves = _leaves(params)
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            logits, aux = model.forward(params, batch)
            loss = lm_loss(logits, batch["labels"], aux)
            grads = torch.autograd.grad(loss, leaves)
            for t in leaves:
                t.requires_grad_(False)
        gtree = unflatten(dict(zip(flatten(params), grads)))
        params, opt, m = apply_updates(params, gtree, opt, ocfg)
        m["loss"] = loss.detach()
        return params, opt, m

    return step


def _batches(cfg, batch=8, seq=16):
    yield from tdata.lm_batches(cfg.vocab, batch, seq, seed=0)


def test_fault_tolerant_resume(tmp_path):
    """Kill training mid-run; restart must resume from the checkpoint and
    finish, with the step counter consistent."""
    cfg = tget("tinyllama_1_1b").smoke(n_layers=1, vocab=32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt = init_state(params)
    step = _make_step(model, AdamWConfig(lr=1e-3))
    loop_cfg = TrainLoopConfig(total_steps=20, ckpt_dir=str(tmp_path),
                               ckpt_every=5, log_every=100)

    def bomb(step_no):
        if step_no == 12:
            raise SimulatedPreemption("host lost")

    with pytest.raises(SimulatedPreemption):
        run(loop_cfg, step, params, opt, _batches(cfg), dict,
            fault_hook=bomb)
    # "new process": restart with FRESH init (must be overwritten by restore)
    params2 = model.init(42)
    opt2 = init_state(params2)
    p_out, o_out, state = run(loop_cfg, step, params2, opt2, _batches(cfg),
                              dict)
    assert state.step == 20
    assert int(o_out.step) == 20
    assert ckpt.latest_step(str(tmp_path)) == 20


def test_straggler_watchdog(tmp_path):
    cfg = tget("tinyllama_1_1b").smoke(n_layers=1, vocab=32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt = init_state(params)
    step0 = _make_step(model, AdamWConfig(lr=1e-3))
    calls = {"n": 0}

    def slow_step(params, opt, batch):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(2.0)  # inject a straggler step (>> smoke step time)
        return step0(params, opt, batch)

    loop_cfg = TrainLoopConfig(total_steps=10, ckpt_dir=str(tmp_path),
                               ckpt_every=100, straggler_factor=3.0)
    _, _, state = run(loop_cfg, slow_step, params, opt, _batches(cfg), dict)
    assert state.stragglers >= 1


# ---------------------------------------------------------------------------
# across a preemption, against the JAX package's loop
# ---------------------------------------------------------------------------

F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
# tests/test_torch_train.py's (loss rel) bounds: exact f32 rounding only;
# pc3_tr STE ~1.5-2x the measured gap of three train steps
LOSS_REL = {"exact": 1e-5, "ste": 2e-3}


@pytest.mark.parametrize("kind", ["exact", "ste"])
def test_losses_across_a_preemption_match_jax(kind, tmp_path):
    """6 steps of ``launch/steps.py``'s train_step, checkpoints every 2,
    preempted before step 3 and resumed from a fresh init, on both sides
    (the JAX package's ``build_artifacts`` on a 1x1 Mesh and its ``run``):
    the resumed run starts at step 2 and every logged loss agrees."""
    if kind == "exact":
        jpol, tpol = "*=exact", "*=exact"
    else:
        jpol = JPolicy.uniform(JConfig(variant=JVariant.PC3_TR))
        tpol = ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR))
    jcfg = jget("tinyllama_1_1b").smoke(**F32).with_policy(jpol)
    tcfg = tget("tinyllama_1_1b").smoke(**F32).with_policy(tpol)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ja = jbuild_artifacts(jcfg, mesh, warmup=1, total_steps=6)
    ta = build_artifacts(tcfg, device="cpu", warmup=1, total_steps=6)

    def bomb(exc):
        def hook(step_no):
            if step_no == 3:
                raise exc("host lost")
        return hook

    losses = {"jax": {}, "port": {}}

    def hook(side):
        def log(step, m):
            losses[side][step] = float(m["loss"])
        return log

    for side in ("jax", "port"):
        loop = jft.TrainLoopConfig(total_steps=6, ckpt_every=2, log_every=1,
                                   ckpt_dir=str(tmp_path / side))
        for attempt, seed in enumerate((0, 42)):
            jp = ja.init_params(jax.random.PRNGKey(seed))
            if side == "jax":
                args = (loop, ja.train_step, jp, ja.init_opt(jp),
                        tdata.lm_batches(128, 2, 16, seed=0),
                        lambda b: {k: jnp.asarray(v) for k, v in b.items()})
                fn, exc = jft.run, jft.SimulatedPreemption
            else:
                tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
                args = (TrainLoopConfig(**vars(loop)), ta.train_step, tp,
                        ta.init_opt(tp), tdata.lm_batches(128, 2, 16, seed=0),
                        dict)
                fn, exc = run, SimulatedPreemption
            if attempt == 0:
                with pytest.raises(exc):
                    fn(*args, fault_hook=bomb(exc), metrics_hook=hook(side))
            else:
                *_, state = fn(*args, metrics_hook=hook(side))
                assert state.step == 6
    # steps 1..3 before the preemption, 3..6 after (the checkpoint is step
    # 2 and the data restarts, so step 3 is logged twice; the later wins)
    assert sorted(losses["port"]) == sorted(losses["jax"]) == list(range(1, 7))
    for step, ref in losses["jax"].items():
        got = losses["port"][step]
        assert np.isfinite(got) and abs(got - ref) <= LOSS_REL[kind] * abs(ref), \
            (step, got, ref)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_train_launcher_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
            "--ckpt", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    _, opt, state = tlaunch.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert state.step == 4 and int(opt.step) == 4
    assert "step     4 loss" in out and "done at step 4" in out
    assert ckpt.latest_step(str(tmp_path)) == 4
    _, opt, state = tlaunch.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert state.step == 6 and int(opt.step) == 6
    # resumed from step 4: steps 5 and 6 only
    assert "step     4 loss" not in out and "step     5 loss" in out
    assert "done at step 6; stragglers seen: 0" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004",
                                            "step_00000006"]


def _step_losses(out):
    return {int(line.split()[1]): float(line.split()[3])
            for line in out.splitlines() if line.startswith("step ")}


@pytest.mark.parametrize("flags", [["--devices", "4"], ["--mesh", "2x2"]])
def test_train_launcher_refuses_more_than_one_device(flags, tmp_path, capfd):
    """(Named when the launcher refused a mesh.) ``--devices 4`` (the
    reference's auto mesh: 2 x 2) and ``--mesh 2x2`` spawn 4 ``gloo`` ranks;
    rank 0 prints the mesh and the global loss of each step, which equals
    the one-device run's within the smoke config's bf16 summation order,
    and the checkpoints land as the one-device run's do."""
    argv = ["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
            "--steps", "3", "--ckpt-every", "3", "--log-every", "1"]
    tlaunch.main(argv + ["--ckpt", str(tmp_path / "one")])
    one = _step_losses(capfd.readouterr().out)
    _, _, state = tlaunch.main(argv + ["--ckpt", str(tmp_path / "mesh")]
                               + flags)
    out = capfd.readouterr().out
    assert state.step == 3
    assert "mesh: {'data': 2, 'model': 2}" in out
    got = _step_losses(out)
    assert sorted(got) == sorted(one) == [1, 2, 3]
    for step, loss in one.items():
        assert abs(got[step] - loss) <= 1e-3 * loss, (step, got, one)
    assert os.listdir(tmp_path / "mesh") == ["step_00000003"]


def test_train_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", "tinyllama_1_1b", "--smoke", "--steps", "1",
                      "--ckpt", str(tmp_path)])
