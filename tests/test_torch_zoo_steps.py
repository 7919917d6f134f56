"""Port parity: the zoo's dense ids (Gemma-2B, StarCoder2-15B,
Nemotron-4-340B) through ``prefill``/``decode_step`` and ``paged_step``
against the JAX package on converted weights (smoke configs, 2 layers;
their forwards are in tests/test_torch_zoo.py, their train steps in
tests/test_torch_zoo_train.py).

Tolerances:
* f32 exact: rtol = atol = 1e-4 and greedy tokens identical, the bounds of
  tests/test_torch_model.py (only f32 rounding and summation order
  differ; measured <= 5e-7 of max|logit|);
* approximate policies: the DAISM products jump at carry boundaries, so a
  1-ulp difference upstream (rsqrt, gelu, exp, cos: the frameworks round
  them apart) moves a product by up to ~2**-3 of itself (see
  tests/test_torch_model.py). Each (id, entry point, spec) is bounded by
  max|dlogits| <= rel * max|ref|, ``rel`` about 1.5x the port-vs-JAX gap
  measured on these inputs (in the comments), with greedy tokens equal on
  every row whose top-2 gap exceeds the bound (f32: on every row).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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


DENSE = ("gemma_2b", "starcoder2_15b", "nemotron_4_340b")
TESTED = DENSE
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
def _smoke(get, arch, kw, spec=None):
    cfg = get(arch).smoke(**kw)
    return cfg.with_policy(spec) if spec else cfg


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's f32 smoke params of each dense id."""
    out = {}
    for arch in TESTED:
        for key, kw in (("f32", F32),):
            p, _ = jbuild(_smoke(jget, arch, kw)).init(jax.random.PRNGKey(0))
            out[(arch, key)] = jax.tree.map(np.asarray, p)
    return out


def _models(arch, spec, key, np_params, port_spec=None):
    kw = F32
    jm = jbuild(_smoke(jget, arch, kw, spec))
    tcfg = _smoke(tget, arch, kw, port_spec or spec)
    tm = tbuild(tcfg, device="cpu")
    p = np_params[(arch, key)]
    return (jm, jax.tree.map(jnp.asarray, p), tm,
            params_from_jax(p, tcfg, device="cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


# decode_step: (arch, spec) -> bound as above (prefill of 2 x 5 tokens,
# then 5 greedy decode steps; measured in the comments)
DECODE_REL = {
    ("gemma_2b", "*=pc3_tr"): 2e-2,                          # 1.30e-2
    ("starcoder2_15b", "*=pc3_tr"): 1.2e-3,                  # 7.98e-4
    ("nemotron_4_340b", "*=pc3_tr"): 1.2e-4,                 # 8.14e-5
}


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
@pytest.mark.parametrize("arch", TESTED)
def test_prefill_then_decode_matches_jax(arch, spec, np_params):
    """``prefill`` of 5 tokens then 5 greedy ``decode_step``s on a slot
    cache; the port feeds JAX's greedy tokens so both see the same
    sequence."""
    jm, jp, tm, tp = _models(arch, spec, "f32", np_params)
    toks = _tokens(2, 5, seed=3)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(toks).long(), tc)
    refs, gots = [np.asarray(jl)], [tl.numpy()]
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(nxt).long(), tc)
        refs.append(np.asarray(jl))
        gots.append(tl.numpy())
        nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert int(tc["pos"]) == int(jc["pos"]) == 10
    ref, got = np.concatenate(refs, 1), np.concatenate(gots, 1)
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - ref).max() <= \
            DECODE_REL[(arch, spec)] * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# paged_step: (arch, spec) -> bound as above (measured in the comments)
PAGED_REL = {
    ("gemma_2b", "*=pc3_tr"): 1.1e-3,                        # 7.35e-4
    ("starcoder2_15b", "*=pc3_tr"): 4.6e-4,                  # 3.07e-4
    ("nemotron_4_340b", "*=pc3_tr"): 5.7e-3,                 # 3.81e-3
}


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
@pytest.mark.parametrize("arch", DENSE)
def test_paged_step_matches_jax(arch, spec, np_params):
    """A chunked-prefill step then a decode step over block tables with
    unmapped entries, a dropped write and a row at an offset (MQA for
    Gemma: one kv head through the pool)."""
    jm, jp, tm, tp = _models(arch, spec, "f32", np_params)
    bs, nb = 8, 8
    jkv, tkv = jm.init_paged_cache(nb, bs), tm.init_paged_cache(nb, bs)
    tables = np.array([[0, 1, -1, -1], [2, 3, 4, -1], [-1, -1, -1, -1]],
                      np.int32)
    toks = _tokens(3, 9, seed=1)
    refs, gots = [], []
    for tk, pos in ((toks, np.array([0, 3, 0], np.int32)),
                    (toks[:, :1], np.array([9, 12, 0], np.int32))):
        jl, jkv = jm.paged_step(jp, jnp.asarray(tk), dict(
            jkv, block_tables=jnp.asarray(tables), pos=jnp.asarray(pos)),
            block_size=bs)
        with torch.no_grad():
            tl, tkv = tm.paged_step(tp, torch.from_numpy(tk).long(), dict(
                tkv, block_tables=torch.from_numpy(tables),
                pos=torch.from_numpy(pos)), block_size=bs)
        refs.append(np.asarray(jl)[:2])  # row 2 has no pages: not compared
        gots.append(tl.numpy()[:2])
    ref = np.concatenate(refs, 1)
    got = np.concatenate(gots, 1)
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - ref).max() <= \
            PAGED_REL[(arch, spec)] * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
