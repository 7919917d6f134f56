"""Port parity: xLSTM-1.3B (``models/xlstm.py``) against the JAX package on
converted weights: the parameter tree at full size, ``forward`` (exact,
PC3_TR on the jnp and pallas routes), a sequence of ``decode_step``s with
the recurrent states compared, one ``train_step`` through
``build_artifacts``, the site log of a policy that splits the mLSTM runs
(their stack rows taken relative to ``base``), and the sLSTM cache's
distinct leaves (smoke config: an mLSTM and an sLSTM block, vocab 128);
and the serving engine's refusal of the three models of this slice that
have no paged step (Whisper, xLSTM, Zamba), as the reference's.

Tolerances: f32 exact rtol = atol = 1e-4 with greedy tokens identical
(tests/test_torch_model.py); approximate policies max|dlogits| <= rel *
max|ref| with ``rel`` about 1.5x the port-vs-JAX gap measured on these
inputs and not below the exact bound (in the comments), greedy tokens
equal on every row whose top-2 gap exceeds the bound; train step 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.launch.steps import build_artifacts as jbuild_artifacts  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "xlstm_1_3b"
F32 = dict(vocab=128, param_dtype="float32", compute_dtype="float32")
BF16 = dict(vocab=128)
# (entry point, spec, dtype) -> bound on max|dlogits| / max|ref|; the
# measured port-vs-JAX gap in the comment
APPROX_REL = {
    ("forward", "*=pc3_tr", "f32"): 3.5e-3,           # 2.12e-3
    ("decode", "*=pc3_tr", "f32"): 1e-4,              # 3.48e-5
    ("forward", "*=pc3_tr:pallas", "bf16"): 0.075,    # 0.0485
}
# (loss rel, grad_norm rel) of one step; measured in the comments
TRAIN_TOL = {"exact": (1e-5, 1e-5),                   # 0.0, 6.0e-8
             "ste": (1e-5, 1e-5)}                     # 9.0e-8, 1.8e-7


def _smoke(get, kw, spec=None):
    cfg = get(ARCH).smoke(**kw)
    return cfg.with_policy(spec) if spec else cfg


def _jax_init(cfg):
    return jax.tree.map(np.asarray, jax.jit(
        lambda r: jbuild(cfg).init(r)[0])(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's smoke params, f32 and bf16 (its own init at each
    dtype)."""
    return {key: _jax_init(_smoke(jget, kw))
            for key, kw in (("f32", F32), ("bf16", BF16))}


def _models(spec, key, np_params, port_spec=None):
    kw = F32 if key == "f32" else BF16
    jm = jbuild(_smoke(jget, kw, spec))
    tcfg = _smoke(tget, kw, port_spec or spec)
    p = np_params[key]
    return (jm, jax.tree.map(jnp.asarray, p), tbuild(tcfg, device="cpu"),
            params_from_jax(p, tcfg, device="cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


def _check(ref, got, case):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert got.shape == ref.shape
    if case[1] == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        return
    bound = APPROX_REL[case] * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.sum() >= 1
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


def test_param_specs_at_full_size_equal_the_reference():
    """``param_specs`` at the published config (42 mLSTM + 6 sLSTM
    blocks): the reference's abstract init's paths, shapes and dtypes, and
    the published 1.06e9 parameters (within 2%)."""
    jshapes, _ = jbuild(jget(ARCH)).init(jax.random.PRNGKey(0), abstract=True)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    model = tbuild(tget(ARCH), device="cpu")
    assert (model.n_m, model.n_s) == (42, 6)
    specs = model.param_specs()
    assert {p: (tuple(s), str(np.dtype(jnp.dtype(d))))
            for p, (s, d, _) in specs.items()} == \
        {p: (tuple(leaf.shape), str(leaf.dtype)) for p, leaf in jflat.items()}
    n = sum(int(np.prod(s)) for s, _, _ in specs.values())
    assert abs(n / 1e9 - 1.06) / 1.06 < 0.02


def test_params_from_jax_covers_every_path_and_rejects_a_wrong_tree(
        np_params):
    cfg = _smoke(tget, F32)
    tp = flatten(params_from_jax(np_params["f32"], cfg, device="cpu"))
    own = flatten(tbuild(cfg, device="cpu").init(0))
    assert {p: (tuple(t.shape), t.dtype) for p, t in own.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in tp.items()}
    assert tp["slstm_blocks/slstm/r_z"].dtype == torch.float32
    bf16 = flatten(params_from_jax(np_params["bf16"], _smoke(tget, BF16),
                                   device="cpu"))
    assert bf16["slstm_blocks/slstm/r_z"].dtype == torch.float32
    assert bf16["mlstm_blocks/mlstm/wgate"].dtype == torch.bfloat16
    bad = jax.tree.map(lambda x: x, np_params["f32"])
    bad["slstm_blocks"]["slstm"]["r_z"] = bad["slstm_blocks"]["slstm"][
        "r_z"][:, :, :-1]
    with pytest.raises(ValueError, match="r_z: shape"):
        params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda x: x, np_params["f32"])
    bad["mlstm_blocks"]["mlstm"]["w_gate"] = bad["mlstm_blocks"]["mlstm"].pop(
        "wgate")
    with pytest.raises(ValueError, match="param paths differ"):
        params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
def test_forward_matches_jax_f32(spec, np_params):
    jm, jp, tm, tp = _models(spec, "f32", np_params)
    toks = _tokens(2, 12, seed=1)
    ref, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    _check(ref, got.numpy(), ("forward", spec, "f32"))
    assert float(aux) == 0.0


def test_bf16_pallas_forward_matches_jax(np_params):
    """bf16 ``*=pc3_tr:pallas`` (the kernel's plain version on the CPU)
    against JAX's jnp backend, the same function."""
    jm, jp, tm, tp = _models("*=pc3_tr", "bf16", np_params,
                             port_spec="*=pc3_tr:pallas")
    toks = _tokens(2, 12, seed=1)
    ref, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    _check(ref, got.float().numpy(), ("forward", "*=pc3_tr:pallas", "bf16"))


def _leaves(cache):
    """{'mlstm/0': array, ..., 'pos': array} of a JAX or a port cache."""
    out = {}
    for k, v in cache.items():
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            out[f"{k}/{i}"] = np.asarray(t.numpy() if torch.is_tensor(t)
                                         else t)
    return out


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
def test_decode_steps_match_jax(spec, np_params):
    """6 ``decode_step``s through ``build_artifacts`` from an empty cache
    against JAX's model: the logits, every state leaf (mLSTM C, n, m; sLSTM
    c, n, m, h) and ``pos``; and the logits against the port's own forward
    over the same tokens."""
    jm, jp, tm, tp = _models(spec, "f32", np_params)
    toks = _tokens(2, 6, seed=2)
    art = build_artifacts(tm.cfg, device="cpu")
    jcache, tcache = jm.init_cache(2, 8), art.init_cache(2, 8)
    jstep = jax.jit(jm.decode_step)
    refs, gots = [], []
    for t in range(6):
        lg, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
        refs.append(np.asarray(lg))
        lg, tcache = art.decode_step(tp, toks[:, t:t + 1], tcache)
        gots.append(lg.numpy())
    got = np.concatenate(gots, 1)
    _check(np.concatenate(refs, 1), got, ("decode", spec, "f32"))
    with torch.no_grad():
        full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-5, atol=1e-5)
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(jl) == sorted(tl)
    assert int(tl["pos/0"]) == 6
    tol = 1e-4 if spec == "*=exact" else APPROX_REL[("decode", spec, "f32")]
    for k in jl:
        assert tl[k].shape == jl[k].shape and tl[k].dtype == jl[k].dtype, k
        np.testing.assert_allclose(tl[k], jl[k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_slstm_cache_leaves_are_distinct_tensors():
    """The reference's sLSTM cache shares one zeros array for c, n and h
    (JAX can alias it); the port writes its cache in place, so each leaf
    is its own tensor, and after a step c, n and h hold their own values;
    the stabilisers start at -inf and stay finite after a step."""
    cfg = _smoke(tget, F32)
    model = tbuild(cfg, device="cpu")
    cache = model.init_cache(1, 4)
    leaves = cache["mlstm"] + cache["slstm"]
    assert len({t.data_ptr() for t in leaves}) == len(leaves) == 7
    assert bool(torch.isneginf(cache["slstm"][2]).all())
    assert bool(torch.isneginf(cache["mlstm"][2]).all())
    params = model.init(0)
    with torch.no_grad():
        _, cache = model.decode_step(params, torch.tensor([[3]]), cache)
    c, n, m, h = cache["slstm"]
    assert not torch.equal(c, n) and not torch.equal(c, h)
    assert bool(torch.isfinite(m).all()) and bool(torch.isfinite(
        cache["mlstm"][2]).all())


def _train_policies(kind):
    from repro.core.config import DaismConfig as JConfig
    from repro.policy import ApproxPolicy as JPolicy
    from repro_torch.core.config import DaismConfig
    from repro_torch.policy import ApproxPolicy

    if kind == "exact":
        return "*=exact", "*=exact"
    return (JPolicy.uniform(JConfig(variant=JVariant.PC3_TR, backward=kind)),
            ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                             backward=kind)))


def _check_train(got, ref, kind):
    for key, rel in zip(("loss", "grad_norm"), TRAIN_TOL[kind]):
        g, r = float(got[key]), float(ref[key])
        assert np.isfinite(g) and abs(g - r) <= rel * abs(r), (key, g, r)


@pytest.mark.parametrize("kind", ["exact", "ste"])
def test_train_step_matches_jax(kind, np_params):
    """One ``train_step`` through ``build_artifacts`` on both sides (the
    reference on a 1x1 ``Mesh``), warmup 1: loss and grad norm (the
    gradients flow through both recurrences) within ``TRAIN_TOL``; the
    step-1 schedule (lr_scale 0) leaves every parameter as it was."""
    jpol, tpol = _train_policies(kind)
    jcfg, tcfg = _smoke(jget, F32, jpol), _smoke(tget, F32, tpol)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ja = jbuild_artifacts(jcfg, mesh, warmup=1, total_steps=100)
    ta = build_artifacts(tcfg, device="cpu", warmup=1, total_steps=100)
    npp = np_params["f32"]
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, tcfg, device="cpu")
    before = {k: v.clone() for k, v in flatten(tp).items()}
    batch = next(lm_batches(128, 2, 16, seed=0))
    _, _, jm = ja.train_step(jp, ja.init_opt(jp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tp, to, tm = ta.train_step(tp, ta.init_opt(tp), batch)
    assert int(to.step) == 1
    _check_train(tm, jm, kind)
    for k, t in flatten(tp).items():
        assert torch.equal(t, before[k]), k


def test_split_mlstm_runs_index_their_stack_from_base():
    """Six blocks, an sLSTM every third (m m s m m s): the second mLSTM run
    holds stack rows 2-3 for global layers 3-4, and a policy that makes
    layer 4 exact splits it into segments ``layer_3`` and ``layer_4``. The
    resolution logs of one forward, ``site_report`` and the logits equal
    the reference's (a row taken by its global index would read past the
    4-row stack or the wrong weights)."""
    from repro.policy import dispatch as jdispatch
    from repro.policy import parse_policy as jparse
    from repro_torch.policy import dispatch as tdispatch
    from repro_torch.policy import parse_policy as tparse

    spec = "*/layer_4/*=exact,*=pc3_tr"
    kw = dict(F32, n_layers=6, slstm_every=3)
    jpol, tpol = jparse(spec, name="xlstm-base"), tparse(spec,
                                                         name="xlstm-base")
    jm = jbuild(_smoke(jget, kw, jpol))
    tcfg = _smoke(tget, kw, tpol)
    tm = tbuild(tcfg, device="cpu")
    assert tm.kinds == jm.kinds == ["mlstm", "mlstm", "slstm"] * 2
    assert tm.segments == jm.segments == ((0, 4), (4, 5), (5, 6))
    npp = _jax_init(_smoke(jget, kw))
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, tcfg, device="cpu")
    toks = _tokens(1, 5, seed=4)
    jdispatch.clear_log(jpol)
    tdispatch.clear_log(tpol)
    ref, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    jlog = {(p, k.value): (c.variant.value, m) for (p, k), (c, _, m) in
            jdispatch.resolution_log(jpol).items()}
    tlog = {(p, k.value): (c.variant.value, m) for (p, k), (c, _, m) in
            tdispatch.resolution_log(tpol).items()}
    assert tlog == jlog
    assert tlog[("xlstm/layer_4/mlstm/wq", "dense")][0] == "exact"
    assert tlog[("xlstm/layer_3/mlstm/wgate", "dense")][0] == "pc3_tr"
    assert tlog[("xlstm/layer_5/slstm/w_down", "dense")][0] == "pc3_tr"
    assert ("xlstm/lm_head", "lm_head") in tlog
    assert tdispatch.site_report(tpol) == jdispatch.site_report(jpol)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("arch", ["whisper_large_v3", "xlstm_1_3b",
                                  "zamba2_1_2b"])
def test_engine_refuses_models_without_a_paged_step(arch):
    """Whisper, xLSTM and Zamba have no ``paged_step``: the serving engine
    (and so ``launch.serve --arch``) refuses them with the reference
    engine's message."""
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve import EngineConfig, ServeEngine

    with pytest.raises(TypeError) as jerr:
        JServeEngine(jbuild(jget(arch).smoke()), None, JEngineConfig())
    with pytest.raises(TypeError) as terr:
        ServeEngine(tbuild(tget(arch).smoke(), device="cpu"), None,
                    EngineConfig())
    assert str(terr.value) == str(jerr.value)
    assert "has no paged_step()" in str(terr.value)
