"""Port parity: the MoE ids (DBRX, Qwen3-MoE; smoke configs, 2 layers)
through ``prefill``/``decode_step`` and ``paged_step`` against the JAX
package on converted weights (the MoE FFN, its routing and forwards are
in tests/test_torch_moe.py, the train steps and the paged-vs-decode
identity in tests/test_torch_moe_train.py).

Tolerances: f32 exact within rtol = atol = 1e-4 (tests/test_torch_model.py)
with greedy tokens identical; approximate policies bounded at ~1.5x the
measured port-vs-JAX gap (carry-boundary jumps amplify 1-ulp framework
differences upstream; tests/test_torch_model.py), measured values in the
comments; the train step's loss and grad norm as tests/test_torch_train.py
bounds them (exact 1e-5; STE ~1.5-2x the measured gap); the port's paged
step equals its decode step bit for bit.
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


MOE = ("dbrx_132b", "qwen3_moe_235b")
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
BF16 = dict(n_layers=2, vocab=128)


@pytest.fixture(scope="module")
def np_params():
    out = {}
    for arch in MOE:
        for key, kw in (("f32", F32), ("bf16", BF16)):
            p, _ = jbuild(jget(arch).smoke(**kw)).init(jax.random.PRNGKey(0))
            out[(arch, key)] = jax.tree.map(np.asarray, p)
    return out


def _models(arch, spec, key, np_params, port_spec=None):
    kw = F32 if key == "f32" else BF16
    jm = jbuild(jget(arch).smoke(**kw).with_policy(spec))
    tcfg = tget(arch).smoke(**kw).with_policy(port_spec or spec)
    p = np_params[(arch, key)]
    return (jm, jax.tree.map(jnp.asarray, p), tbuild(tcfg, device="cpu"),
            params_from_jax(p, tcfg, device="cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


# (arch, entry point, spec) -> bound on max|dlogits| / max|ref| and on
# |daux| / |aux|; measured port-vs-JAX gaps in the comments
REL = {
    ("dbrx_132b", "decode", "*=pc3_tr"): 1.75e-2,                  # 1.16e-2
    ("qwen3_moe_235b", "decode", "*=pc3_tr"): 1.75e-2,             # 1.17e-2
    ("dbrx_132b", "paged", "*=pc3_tr"): 6.4e-3,                    # 4.24e-3
    ("qwen3_moe_235b", "paged", "*=pc3_tr"): 3e-2,                 # 2.02e-2
}
def _close(got, ref, arch, entry, spec):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert got.shape == ref.shape
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - ref).max() <= \
            REL[(arch, entry, spec)] * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_matches_jax(arch, spec, np_params):
    """``prefill`` of 5 tokens, then 5 greedy ``decode_step``s (the port
    fed JAX's tokens)."""
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
    _close(np.concatenate(refs, 1), np.concatenate(gots, 1), arch, "decode",
           spec)


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
@pytest.mark.parametrize("arch", MOE)
def test_paged_step_matches_jax(arch, spec, np_params):
    """A chunked-prefill step then a decode step over block tables (an
    unmapped row, a dropped write, a row at an offset)."""
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
        refs.append(np.asarray(jl)[:2])
        gots.append(tl.numpy()[:2])
    _close(np.concatenate(refs, 1), np.concatenate(gots, 1), arch, "paged",
           spec)
