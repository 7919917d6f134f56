"""Port parity: the training pieces (lm_loss, AdamW, schedules, synthetic
data) and ``launch/steps.py``'s train and prefill steps against the JAX
package. Tolerances are stated beside each check."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.data.synthetic as jdata  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.launch.steps import build_artifacts as jbuild_artifacts  # noqa: E402
from repro.models.registry import lm_loss as jlm_loss  # noqa: E402
from repro.policy import ApproxPolicy as JPolicy  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import Backend, DaismConfig, Variant  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402
from repro_torch.models.registry import lm_loss  # noqa: E402
from repro_torch.policy import ApproxPolicy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_np(tree):
    """``{"a/b": np.ndarray}`` of a JAX tree (keys as the port's flatten)."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _t(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


# ---------------------------------------------------------------------------
# pieces: within 1e-6 (only the f32 rounding of transcendental functions
# and of sums differs between the frameworks)
# ---------------------------------------------------------------------------


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    for aux in (0.0, 0.5):
        ref = float(jlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                             jnp.float32(aux)))
        got = float(lm_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels), aux))
        assert abs(got - ref) <= 1e-6 * abs(ref)
    # bf16 logits are promoted to f32 first, as in the reference
    b16 = jnp.asarray(logits, jnp.bfloat16)
    ref = float(jlm_loss(b16, jnp.asarray(labels)))
    got = float(lm_loss(_t(b16), torch.from_numpy(labels)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_apply_updates_matches_jax():
    """Three AdamW steps on a random tree with f32 and bf16 leaves, clipping
    active on the second: params, master, m, v, grad_norm and lr agree
    within rtol 1e-6 (bf16 params: identical after the same rounding, or
    one ulp where the f32 masters straddle a rounding boundary)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "blocks": {"w": (2, 5), "s": (5,)}}
    p_np = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "blocks": {"w": rng.normal(size=(2, 5)).astype(np.float32),
                       "s": rng.normal(size=(5,)).astype(np.float32)}}
    jp = {"a": jnp.asarray(p_np["a"]),
          "blocks": {"w": jnp.asarray(p_np["blocks"]["w"], jnp.bfloat16),
                     "s": jnp.asarray(p_np["blocks"]["s"])}}
    tp = jax.tree.map(_t, jp)
    jcfg = jopt.AdamWConfig(lr=1e-2, grad_clip=2.0)
    tcfg = topt.AdamWConfig(lr=1e-2, grad_clip=2.0)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for step, (scale, lr_scale) in enumerate([(0.1, 1.0), (5.0, 0.5),
                                              (0.3, 0.25)]):
        g = jax.tree.map(lambda s: jnp.asarray(
            rng.normal(size=s).astype(np.float32) * scale), shapes,
            is_leaf=lambda x: isinstance(x, tuple))
        g["blocks"]["w"] = g["blocks"]["w"].astype(jnp.bfloat16)
        jp, js, jm = jopt.apply_updates(jp, g, js, jcfg, jnp.float32(lr_scale))
        tp, ts, tm = topt.apply_updates(tp, jax.tree.map(_t, g), ts, tcfg,
                                        lr_scale)
        assert int(ts.step) == int(js.step) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        for jtree, ttree in ((js.master, ts.master), (js.m, ts.m),
                             (js.v, ts.v)):
            for k, ref in _flat_np(jtree).items():
                np.testing.assert_allclose(flatten(ttree)[k].numpy(), ref,
                                           rtol=1e-6, atol=1e-9)
        tflat = flatten(tp)
        for k, ref in _flat_np(jp).items():
            got = tflat[k]
            assert str(got.dtype).endswith(ref.dtype.name)
            np.testing.assert_allclose(got.float().numpy(),
                                       ref.astype(np.float32),
                                       rtol=2**-7 if got.dtype ==
                                       torch.bfloat16 else 1e-6)


def test_schedules_match_jax():
    for step in (0, 1, 3, 10, 11, 55, 100, 150):
        for kw in (dict(warmup=10, total=100), dict(warmup=1, total=100),
                   dict(warmup=10, total=100, min_ratio=0.3)):
            ref = float(jopt.cosine_with_warmup(jnp.int32(step), **kw))
            got = float(topt.cosine_with_warmup(torch.tensor(step,
                                                             dtype=torch.int32),
                                                **kw))
            assert abs(got - ref) <= 1e-6, (step, kw)
        ref = float(jopt.linear_warmup(jnp.int32(step), warmup=10))
        assert abs(float(topt.linear_warmup(step, warmup=10)) - ref) <= 1e-6


def test_synthetic_data_is_identical():
    jg, tg = jdata.lm_batches(97, 3, 11, seed=4), tdata.lm_batches(97, 3, 11,
                                                                  seed=4)
    for _ in range(3):
        ref, got = next(jg), next(tg)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], ref[k])
            assert got[k].dtype == ref[k].dtype
    kw = dict(shape=(8, 8, 1), seed=2, max_shift=2)
    ref = jdata.eval_set(jdata.image_batches(5, 4, **kw), 2)
    got = tdata.eval_set(tdata.image_batches(5, 4, **kw), 2)
    for r, g in zip(ref, got):
        for k in ("images", "labels"):
            np.testing.assert_array_equal(g[k], r[k])
            assert g[k].dtype == r[k].dtype


# ---------------------------------------------------------------------------
# train_step / prefill_step against the JAX package's build_artifacts
# ---------------------------------------------------------------------------

F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")

# (loss rel, grad_norm rel, param rel) bounds per policy; measured values
# in the comments. ``param rel`` bounds ||p_port - p_jax|| / ||p_jax -
# p_before|| over all parameters after a step (the update's L2 error).
# exact: f32 rounding and summation order only.
# pc3_tr: the approximate products jump at carry boundaries, so the
# frameworks' 1-ulp differences upstream move the loss by ~1.5e-4 of itself
# already at step 1 (the f32 forward parity of tests/test_torch_model.py),
# and single gradient elements by more. AdamW's early updates are close to
# sign(g) per element, so an element whose gradient is near zero can move
# either way: parameters are compared as one update vector, by its L2
# error relative to the step, not element by element. Bounds ~1.5-2x the
# measured gaps.
TRAIN_TOL = {
    "exact": (1e-5, 1e-5, 1e-4),     # 1e-7, 1.7e-7, 8.6e-6
    "ste": (2e-3, 2e-3, 0.08),       # 8.7e-4, 8.1e-4, 0.041
    "approx": (2e-3, 4e-3, 0.2),     # 1.06e-3, 1.8e-3, 0.128
}


def _policies(kind):
    if kind == "exact":
        return "*=exact", "*=exact"
    return (JPolicy.uniform(JConfig(variant=JVariant.PC3_TR, backward=kind)),
            ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                             backward=kind)))


@pytest.mark.parametrize("kind", ["exact", "ste", "approx"])
def test_train_steps_match_jax(kind):
    """Three train_steps on the f32 smoke config (jnp backend), both sides
    with warmup=1: the schedule reads the step before it is incremented, so
    step 1 has lr_scale 0 and leaves the parameters exactly as they were on
    both sides; steps 2 and 3 move them. Loss, grad_norm and parameters are
    compared after each step (bounds in TRAIN_TOL)."""
    jpol, tpol = _policies(kind)
    jcfg = jget("tinyllama_1_1b").smoke(**F32).with_policy(jpol)
    tcfg = tget("tinyllama_1_1b").smoke(**F32).with_policy(tpol)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ja = jbuild_artifacts(jcfg, mesh, warmup=1, total_steps=100)
    ta = build_artifacts(tcfg, device="cpu", warmup=1, total_steps=100)
    jp = ja.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jo, to = ja.init_opt(jp), ta.init_opt(tp)
    loss_rel, gn_rel, p_rel = TRAIN_TOL[kind]
    batches = tdata.lm_batches(128, 2, 16, seed=0)
    for step in range(3):
        batch = next(batches)
        before = {k: v.clone() for k, v in flatten(tp).items()}
        jp, jo, jm = ja.train_step(jp, jo, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        tp, to, tm = ta.train_step(tp, to, batch)
        assert int(to.step) == step + 1
        for key, rel in (("loss", loss_rel), ("grad_norm", gn_rel)):
            got, ref = float(tm[key]), float(jm[key])
            assert np.isfinite(got) and abs(got - ref) <= rel * abs(ref), \
                (step, key, got, ref)
        jflat, tflat = _flat_np(jp), flatten(tp)
        if step == 0:
            for k, t in tflat.items():
                assert torch.equal(t, before[k]), k
                np.testing.assert_array_equal(jflat[k], before[k].numpy())
            continue
        err = np.sqrt(sum(np.sum((tflat[k].numpy() - jflat[k]) ** 2)
                          for k in tflat))
        moved = np.sqrt(sum(np.sum((jflat[k] - before[k].numpy()) ** 2)
                            for k in tflat))
        assert moved > 0 and err <= p_rel * moved, (step, err, moved)


def test_prefill_step_matches_forward_and_decode_step_is_not_ported():
    cfg = tget("tinyllama_1_1b").smoke(n_layers=2, vocab=64).with_policy(
        "*/attn/kernel=exact:flash,*=pc3_tr:pallas")
    art = build_artifacts(cfg, device="cpu")
    params = art.init_params(0)
    toks = np.random.default_rng(0).integers(0, 64, size=(1, 9))
    logits = art.prefill_step(params, {"tokens": toks})
    ref, _ = art.model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert not logits.requires_grad
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="slot caches"):
        art.decode_step(params, toks, None)


def test_train_step_under_a_flash_policy_raises():
    """The flash kernel has no backward (nor has the reference's)."""
    cfg = tget("tinyllama_1_1b").smoke(n_layers=2, vocab=64).with_policy(
        "*/attn/kernel=exact:flash,*=pc3_tr:pallas")
    art = build_artifacts(cfg, device="cpu")
    params = art.init_params(0)
    opt = art.init_opt(params)
    batch = next(tdata.lm_batches(64, 1, 8, seed=0))
    with pytest.raises(NotImplementedError, match="no backward"):
        art.train_step(params, opt, batch)
    assert not any(t.requires_grad for t in flatten(params).values())


def test_train_step_approx_backward_runs_the_pallas_spelling():
    """bf16, ``backend='pallas'`` with ``backward='approx'`` (refused by the
    JAX package, run by the port): on CPU tensors the backward GEMMs take
    the kernel's plain version; the step is finite and gives the same
    gradients as the jnp backend's approximate backward, up to f32
    summation order (grad_norm within 1e-3 relative)."""
    base = tget("tinyllama_1_1b").smoke(n_layers=2, vocab=64)
    norms = []
    for backend in (Backend.PALLAS, Backend.JNP):
        cfg = base.with_policy(ApproxPolicy.uniform(DaismConfig(
            variant=Variant.PC3_TR, backend=backend, backward="approx")))
        art = build_artifacts(cfg, device="cpu", warmup=1)
        params = art.init_params(0)
        opt = art.init_opt(params)
        batch = next(tdata.lm_batches(64, 2, 8, seed=1))
        params, opt, m = art.train_step(params, opt, batch)
        assert np.isfinite(float(m["loss"])) and np.isfinite(
            float(m["grad_norm"]))
        norms.append(float(m["grad_norm"]))
    assert abs(norms[0] - norms[1]) <= 1e-3 * norms[1]
