"""Port parity: activation checkpointing (``cfg.remat``,
``models/transformer.py::apply_remat``) in every family's layer loop.

* On the CPU, the train step under ``dots``, ``dots_nb`` and ``full`` is
  bit for bit the step under ``none``: losses, grad norms and every
  parameter after 2 steps ``torch.equal`` (TinyLlama, xLSTM and Zamba
  smoke configs, f32, under ``*=exact`` and under PC3_TR on the
  ``pallas`` backend, whose plain version the recompute runs again);
  the site scopes are all closed after every step.
* Under each mode, 2 steps of the port against the reference's step
  under the same mode on a 1 x 1 ``Mesh`` (``*=exact``), within
  ``tests/test_torch_train.py``'s ``TRAIN_TOL``.
* An unknown mode raises, in ``ArchConfig`` and in ``apply_remat``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.steps import build_artifacts as jbuild  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.module import flatten, unflatten  # noqa: E402
from repro_torch.models.transformer import REMAT_MODES, apply_remat  # noqa: E402
from repro_torch.policy import current_prefix  # noqa: E402

from test_torch_train import TRAIN_TOL  # noqa: E402

F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ("tinyllama_1_1b", "xlstm_1_3b", "zamba2_1_2b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(cfg, params, n=2):
    """``n`` train steps from ``params`` (copied): the metrics and the
    final parameters."""
    art = build_artifacts(cfg, device="cpu", warmup=1, total_steps=100)
    p = unflatten({k: v.clone() for k, v in flatten(params).items()})
    opt = art.init_opt(p)
    batches = tdata.lm_batches(cfg.vocab, 2, 8, seed=0)
    metrics = []
    for _ in range(n):
        p, opt, m = art.train_step(p, opt, next(batches))
        metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
    return metrics, flatten(p)


@pytest.mark.parametrize("policy", ["*=exact", "*=pc3_tr:pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_mode_is_bit_for_bit_the_plain_step(arch, policy):
    base = tget(arch).smoke(**dict(F32) if policy == "*=exact"
                            else {}).with_policy(policy)
    params = build_artifacts(base, device="cpu").init_params(0)
    want_m, want_p = _steps(base, params)
    for mode in REMAT_MODES[1:]:
        got_m, got_p = _steps(dataclasses.replace(base, remat=mode), params)
        # the forward's and the recompute's site scopes are all closed
        assert current_prefix() == (), (mode, current_prefix())
        for (gl, gn), (wl, wn) in zip(got_m, want_m):
            assert torch.equal(gl, wl) and torch.equal(gn, wn), mode
        for k, v in want_p.items():
            assert torch.equal(got_p[k], v), (mode, k)


def _flat_np(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_each_mode_matches_the_reference_under_it(arch):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    loss_rel, gn_rel, p_rel = TRAIN_TOL["exact"]
    jparams = None
    for mode in REMAT_MODES:
        jcfg = dataclasses.replace(jget(arch).smoke(**F32), remat=mode)
        tcfg = dataclasses.replace(tget(arch).smoke(**F32), remat=mode)
        ja = jbuild(jcfg, mesh, warmup=1, total_steps=100)
        if jparams is None:
            jparams = jax.tree.map(np.asarray,
                                   ja.init_params(jax.random.PRNGKey(0)))
        tp = params_from_jax(jparams, tcfg, device="cpu")
        got_m, got_p = _steps(tcfg, tp)
        jp = jax.tree.map(jnp.asarray, jparams)
        jo = ja.init_opt(jp)
        batches = tdata.lm_batches(tcfg.vocab, 2, 8, seed=0)
        for (gl, gn) in got_m:
            jp, jo, jm = ja.train_step(jp, jo, {
                k: jnp.asarray(v) for k, v in next(batches).items()})
            for got, ref, rel in ((gl, jm["loss"], loss_rel),
                                  (gn, jm["grad_norm"], gn_rel)):
                assert abs(float(got) - float(ref)) <= rel * abs(float(ref)), (
                    mode, float(got), float(ref))
        want = _flat_np(jp)
        init = _flat_np(jparams)
        err = np.sqrt(sum(np.sum((got_p[k].numpy() - want[k]) ** 2)
                          for k in want))
        moved = np.sqrt(sum(np.sum((want[k] - init[k]) ** 2) for k in want))
        assert moved > 0 and err <= p_rel * moved, (mode, err, moved)


def test_an_unknown_mode_raises():
    with pytest.raises(ValueError, match="remat='offload'"):
        dataclasses.replace(tget("tinyllama_1_1b"), remat="offload")
    with pytest.raises(ValueError, match="remat='dot'"):
        apply_remat(lambda x: x, "dot")
