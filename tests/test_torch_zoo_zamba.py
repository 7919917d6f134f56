"""Port parity: Zamba2-1.2B (``models/zamba.py``) against the JAX package on
converted weights: the parameter tree at full size, the depthwise causal
conv against ``lax.conv_general_dilated``, ``forward`` (exact, PC3_TR on
the jnp and pallas routes), sequences of ``decode_step``s (a plain cache,
and the shared block's ring cache at ``window = 4``, run past the window)
with the states and KV caches compared, one ``train_step`` through
``build_artifacts``, and the site log of a policy on the shared block
(smoke config: 3 Mamba-2 blocks, the shared block after the second,
vocab 128).

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
from jax import lax  # noqa: E402

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


ARCH = "zamba2_1_2b"
F32 = dict(vocab=128, param_dtype="float32", compute_dtype="float32")
BF16 = dict(vocab=128)
RING = dict(F32, window=4)
# (entry point, spec, dtype) -> bound on max|dlogits| / max|ref|; the
# measured port-vs-JAX gap in the comment
APPROX_REL = {
    ("forward", "*=pc3_tr", "f32"): 1e-4,             # 1.59e-5
    ("decode", "*=pc3_tr", "f32"): 7e-4,              # 4.51e-4
    ("forward", "*=pc3_tr:pallas", "bf16"): 0.07,     # 0.0458
}
# (loss rel, grad_norm rel) of one step; measured in the comments
TRAIN_TOL = {"exact": (1e-5, 1e-5),                   # 8.7e-8, 0.0
             "ste": (1e-5, 1e-5)}                     # 8.8e-8, 1.0e-7


def _smoke(get, kw, spec=None):
    cfg = get(ARCH).smoke(**kw)
    return cfg.with_policy(spec) if spec else cfg


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's smoke params, f32 and bf16 (its own init at each
    dtype)."""
    return {key: jax.tree.map(np.asarray, jax.jit(
        lambda r, kw=kw: jbuild(_smoke(jget, kw)).init(r)[0])(
            jax.random.PRNGKey(0))) for key, kw in (("f32", F32),
                                                    ("bf16", BF16))}


def _models(spec, key, np_params, port_spec=None, kw=None):
    kw = kw or (F32 if key == "f32" else BF16)
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
    """``param_specs`` at the published config (38 Mamba-2 blocks, 6 shared
    sites, 2 tail blocks): the reference's abstract init's paths, shapes
    (``conv_w`` in its ``HIO`` layout) and dtypes, and the published
    1.19e9 parameters (within 2%)."""
    jshapes, _ = jbuild(jget(ARCH)).init(jax.random.PRNGKey(0), abstract=True)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    model = tbuild(tget(ARCH), device="cpu")
    assert model.n_sites == 6 and model._groups()[-1] == (36, 38, None)
    specs = model.param_specs()
    assert specs["mamba_blocks/mamba/conv_w"][0] == (38, 4, 1, 4096)
    assert {p: (tuple(s), str(np.dtype(jnp.dtype(d))))
            for p, (s, d, _) in specs.items()} == \
        {p: (tuple(leaf.shape), str(leaf.dtype)) for p, leaf in jflat.items()}
    n = sum(int(np.prod(s)) for s, _, _ in specs.values())
    assert abs(n / 1e9 - 1.19) / 1.19 < 0.02


def test_params_from_jax_covers_every_path_and_rejects_a_wrong_tree(
        np_params):
    cfg = _smoke(tget, F32)
    tp = flatten(params_from_jax(np_params["f32"], cfg, device="cpu"))
    own = flatten(tbuild(cfg, device="cpu").init(0))
    assert {p: (tuple(t.shape), t.dtype) for p, t in own.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in tp.items()}
    bad = jax.tree.map(lambda x: x, np_params["f32"])
    mamba = bad["mamba_blocks"]["mamba"]
    mamba["conv_w"] = np.swapaxes(mamba["conv_w"], 1, 3)  # not HIO
    with pytest.raises(ValueError, match="conv_w: shape"):
        params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda x: x, np_params["bf16"])
    bad["mamba_blocks"]["mamba"]["a_log"] = bad["mamba_blocks"]["mamba"][
        "a_log"].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        params_from_jax(bad, _smoke(tget, BF16), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv_matches_lax_conv(dtype):
    """The reference's ``lax.conv_general_dilated`` (``HIO`` weights, one
    group per channel, VALID over the left-padded sequence): a
    cross-correlation, taps not flipped; f32 within 1e-6, bf16 within one
    rounding."""
    from repro_torch.models.zamba import causal_depthwise_conv

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9 + 3, 40)).astype(np.float32)
    w = rng.normal(size=(4, 1, 40)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = lax.conv_general_dilated(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), (1,), "VALID",
        dimension_numbers=("NHC", "HIO", "NHC"), feature_group_count=40)
    tdt = getattr(torch, dtype)
    got = causal_depthwise_conv(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, 9, 40)
    ref = np.asarray(ref, np.float32)
    tol = 1e-6 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


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


def _leaves(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.numpy() if torch.is_tensor(v)
                                         else v)
    return out


@pytest.mark.parametrize("spec,kw,steps", [("*=exact", F32, 6),
                                           ("*=pc3_tr", F32, 6),
                                           ("*=exact", RING, 8)])
def test_decode_steps_match_jax(spec, kw, steps, np_params):
    """``decode_step``s through ``build_artifacts`` from an empty cache of
    16 cells against JAX's model: the logits and every cache leaf (conv and
    SSM states, the shared site's ``k``/``v``, ``pos``; with ``window = 4``
    the ring's ``abs_pos`` too, 8 steps running past the window, as
    tests/test_models.py's ring test does). Without the ring, the logits
    also equal the port's own forward over the same tokens."""
    jm, jp, tm, tp = _models(spec, "f32", np_params, kw=kw)
    ring = kw is RING
    toks = _tokens(2, steps, seed=2)
    art = build_artifacts(tm.cfg, device="cpu")
    jcache, tcache = jm.init_cache(2, 16), art.init_cache(2, 16)
    assert ("abs_pos" in tcache["attn_0"]) == ring
    jstep = jax.jit(jm.decode_step)
    refs, gots = [], []
    for t in range(steps):
        lg, jcache = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
        refs.append(np.asarray(lg))
        lg, tcache = art.decode_step(tp, toks[:, t:t + 1], tcache)
        gots.append(lg.numpy())
    got = np.concatenate(gots, 1)
    _check(np.concatenate(refs, 1), got, ("decode", spec, "f32"))
    if not ring:
        with torch.no_grad():
            full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
        np.testing.assert_allclose(got, full.numpy(), rtol=1e-5, atol=1e-5)
    jl, tl = _leaves(jcache), _leaves(tcache)
    assert sorted(jl) == sorted(tl)
    assert int(tl["pos"]) == steps
    if ring:
        assert tl["attn_0/abs_pos"].tolist() == [4, 5, 6, 7]
    tol = 1e-4 if spec == "*=exact" else APPROX_REL[("decode", spec, "f32")]
    for k in jl:
        assert tl[k].shape == jl[k].shape and tl[k].dtype == jl[k].dtype, k
        np.testing.assert_allclose(tl[k], jl[k], rtol=tol, atol=tol,
                                   err_msg=k)


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
    reference on a 1x1 ``Mesh``), warmup 1: loss and grad norm (through the
    SSD scan, the conv and the shared block, whose gradient sums over its
    sites) within ``TRAIN_TOL``; the step-1 schedule (lr_scale 0) leaves
    every parameter as it was."""
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


def test_site_log_and_report_equal_the_reference(np_params):
    """A policy that runs the shared block exact and asks for flash
    attention everywhere: the resolution logs of one forward and
    ``site_report`` equal the reference's; the windowed shared attention
    resolves exact (a window is not flash-eligible) and launches nothing."""
    from repro.policy import dispatch as jdispatch
    from repro.policy import parse_policy as jparse
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.policy import dispatch as tdispatch
    from repro_torch.policy import parse_policy as tparse

    spec = "*/kernel=pc3_tr:flash,*/shared_0/*=exact,*=pc3_tr"
    jpol, tpol = jparse(spec, name="zamba"), tparse(spec, name="zamba")
    jm = jbuild(_smoke(jget, F32, jpol))
    tcfg = _smoke(tget, F32, tpol)
    tm = tbuild(tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, np_params["f32"])
    tp = params_from_jax(np_params["f32"], tcfg, device="cpu")
    toks = _tokens(1, 5, seed=4)
    jdispatch.clear_log(jpol)
    tdispatch.clear_log(tpol)
    ref, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    before = fa.launches
    with torch.no_grad():
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert fa.launches == before
    jlog = {(p, k.value): (c.variant.value, c.attn_kernel, m)
            for (p, k), (c, _, m) in jdispatch.resolution_log(jpol).items()}
    tlog = {(p, k.value): (c.variant.value, c.attn_kernel, m)
            for (p, k), (c, _, m) in tdispatch.resolution_log(tpol).items()}
    assert tlog == jlog
    assert tlog[("zamba/shared_0/attn/kernel", "attn_qk")][0] == "exact"
    assert tlog[("zamba/shared_0/ffn/wg", "dense")][0] == "exact"
    assert tlog[("zamba/layer_0/mamba/dt_proj", "dense")][0] == "pc3_tr"
    assert tdispatch.site_report(tpol) == jdispatch.site_report(jpol)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(ref).argmax(-1))
