"""Port parity: slot-cache generation (``init_cache``, ``prefill``,
``decode_step``; scalar, per-slot and ring ``pos``) and
``paged_verify_step`` on converted JAX weights (f32 smoke TinyLlama, 2
layers).

Tolerances:
* exact policies: rtol = atol = 1e-4, as in tests/test_torch_model.py
  (only f32 rounding of the elementwise ops and the summation order
  differ; measured <= 5e-7 of max|logit|);
* approximate policies: the DAISM products are discontinuous at carry
  boundaries, so the frameworks' 1-ulp differences upstream (rsqrt, silu,
  exp, cos) can move a product by up to ~2**-3 of itself (see
  tests/test_torch_model.py). ``prefill`` and ``decode_step`` are entry
  points of their own, so each (entry point, spec) has its bound on
  max|dlogits| / max|ref| (``CACHE_REL``), about 1.5x the port-vs-JAX gap
  measured on these inputs (in the comments); greedy tokens must be equal.
* ``paged_verify_step``'s greedy tokens and accept counts are integers:
  equal, exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
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


F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
SPECS = ["*=exact", "*=pc3_tr", "*/attn/*=exact,*=pc3_tr"]
# (entry point, spec) -> bound on max|dlogits| / max|ref|; measured gap in
# the comment (prefill of 3 x 5 tokens, then 6 greedy decode steps)
CACHE_REL = {
    ("prefill", "*=pc3_tr"): 3e-5,                      # 1.78e-5
    ("prefill", "*/attn/*=exact,*=pc3_tr"): 2.6e-2,     # 1.72e-2
    ("decode_step", "*=pc3_tr"): 4.2e-2,                # 2.77e-2
    ("decode_step", "*/attn/*=exact,*=pc3_tr"): 4e-3,   # 2.63e-3
}


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's f32 smoke params (window 0; a ring cache changes
    no parameter)."""
    model = jbuild(jget("tinyllama_1_1b").smoke(**F32))
    params, _ = model.init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _models(spec, np_params, **kw):
    kw = dict(F32, **kw)
    jm = jbuild(jget("tinyllama_1_1b").smoke(**kw).with_policy(spec))
    tcfg = tget("tinyllama_1_1b").smoke(**kw).with_policy(spec)
    tm = tbuild(tcfg, device="cpu")
    return (jm, jax.tree.map(jnp.asarray, np_params), tm,
            params_from_jax(np_params, tcfg, device="cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _check(ref, got, spec, entry):
    ref = np.asarray(ref, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        rel = CACHE_REL[(entry, spec)]
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _check_cache(jc, tc, rtol=1e-4):
    """The caches' keys agree; pos and abs_pos exactly, k/v within rtol."""
    assert set(jc) == set(tc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if "abs_pos" in jc:
        np.testing.assert_array_equal(tc["abs_pos"].numpy(),
                                      np.asarray(jc["abs_pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=rtol, atol=rtol)


@pytest.mark.parametrize("window,max_seq", [(0, 16), (4, 16), (32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(window, max_seq, dtype):
    """Keys, shapes, dtypes and fill of the cache tree equal JAX's: a ring
    where the window is shorter than max_seq, a plain cache otherwise."""
    kw = dict(n_layers=2, vocab=128, window=window, param_dtype=dtype,
              compute_dtype=dtype)
    jc = jbuild(jget("tinyllama_1_1b").smoke(**kw)).init_cache(3, max_seq)
    tc = tbuild(tget("tinyllama_1_1b").smoke(**kw),
                device="cpu").init_cache(3, max_seq)
    assert set(tc) == set(jc) == ({"k", "v", "pos", "abs_pos"}
                                  if 0 < window < max_seq
                                  else {"k", "v", "pos"})
    for key, ref in jc.items():
        ref = np.asarray(ref)
        got = tc[key]
        assert tuple(got.shape) == ref.shape, key
        assert str(got.dtype).replace("torch.", "") == ref.dtype.name, key
        np.testing.assert_array_equal(got.float().numpy(),
                                      ref.astype(np.float32))


@pytest.mark.parametrize("spec", SPECS)
def test_prefill_then_decode_matches_jax(spec, np_params):
    """B = 3 prompts of 5 tokens, then 6 greedy decode steps on a scalar-pos
    cache of 16: logits at every step, and (exact) the cache itself."""
    jm, jp, tm, tp = _models(spec, np_params)
    toks = _tokens(3, 5)
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16)
    ref, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    got, tc = tm.prefill(tp, _t(toks), tc)
    _check(ref, got, spec, "prefill")
    assert int(tc["pos"]) == 5 and tc["pos"].dtype == torch.int32
    nxt = np.asarray(ref)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(6):
        ref, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        got, tc = tm.decode_step(tp, _t(nxt), tc)
        _check(ref, got, spec, "decode_step")
        nxt = np.asarray(ref)[:, -1].argmax(-1)[:, None].astype(np.int32)
    assert int(tc["pos"]) == 11
    if spec == "*=exact":
        _check_cache(jc, tc)


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
def test_per_slot_decode_matches_jax(spec, np_params):
    """A (B,) ``pos`` vector: rows at staggered offsets (right-padded prompts
    of true lengths 5, 2 and 4), each writing at its own offset."""
    jm, jp, tm, tp = _models(spec, np_params)
    toks = _tokens(3, 5, seed=1)
    lens = np.array([5, 2, 4], np.int32)
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16)
    ref, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    got, tc = tm.prefill(tp, _t(toks), tc)
    jc = dict(jc, pos=jnp.asarray(lens))
    tc = dict(tc, pos=torch.from_numpy(lens))
    ref = np.asarray(ref)
    nxt = ref[np.arange(3), lens - 1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(4):
        ref, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        got, tc = tm.decode_step(tp, _t(nxt), tc)
        _check(ref, got, spec, "decode_step")
        nxt = np.asarray(ref)[:, -1].argmax(-1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(tc["pos"].numpy(), lens + 4)
    if spec == "*=exact":
        _check_cache(jc, tc)


def test_ring_decode_past_the_window_matches_jax(np_params):
    """window 4 in a 16-token budget makes a 4-cell ring: 12 decode steps
    wrap it twice; logits at every step and ``abs_pos`` (which cell holds
    which position, -1 while empty) against JAX, exact f32."""
    jm, jp, tm, tp = _models("*=exact", np_params, window=4)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    assert tuple(tc["abs_pos"].shape) == (2, 4)
    nxt = _tokens(2, 1, seed=2)
    for step in range(12):
        ref, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        got, tc = tm.decode_step(tp, _t(nxt), tc)
        _check(ref, got, "*=exact", "decode_step")
        np.testing.assert_array_equal(tc["abs_pos"].numpy(),
                                      np.asarray(jc["abs_pos"]))
        nxt = np.asarray(ref)[:, -1].argmax(-1)[:, None].astype(np.int32)
    # positions 8..11 fill cells 0..3 after the second wrap
    np.testing.assert_array_equal(tc["abs_pos"].numpy(),
                                  np.tile(np.arange(8, 12), (2, 1)))
    _check_cache(jc, tc)


def test_ring_cache_refuses_prefill_and_per_slot_pos(np_params):
    _, _, tm, tp = _models("*=exact", np_params, window=4)
    cache = tm.init_cache(2, 16)
    with pytest.raises(NotImplementedError, match="ring"):
        tm.prefill(tp, _t(_tokens(2, 3)), cache)
    with pytest.raises(NotImplementedError, match="ring"):
        tm.decode_step(tp, _t(_tokens(2, 1)),
                       dict(cache, pos=torch.zeros(2, dtype=torch.int32)))
    _, _, tm, tp = _models("*=exact", np_params)
    cache = tm.init_cache(2, 16)
    with pytest.raises(ValueError, match="scalar-pos"):
        tm.prefill(tp, _t(_tokens(2, 3)),
                   dict(cache, pos=torch.zeros(2, dtype=torch.int32)))


@pytest.mark.parametrize("per_slot", [False, True])
def test_write_past_the_end_clamps_as_jax(per_slot, np_params):
    """``lax.dynamic_update_slice`` clamps its start so that the slice fits:
    a write at pos > size - S lands at size - S. A prefill of 3 tokens at
    pos 6 of an 8-cell cache writes cells 5..7; a decode at pos 8 (or at
    pos 9 in one row of a per-slot vector) writes cell 7. Logits and the
    cache against JAX, exact f32."""
    jm, jp, tm, tp = _models("*=exact", np_params)
    jc, tc = jm.init_cache(2, 8), tm.init_cache(2, 8)
    toks = _tokens(2, 6, seed=3)
    ref, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    got, tc = tm.prefill(tp, _t(toks), tc)
    more = _tokens(2, 3, seed=4)
    ref, jc = jm.prefill(jp, jnp.asarray(more), jc)
    got, tc = tm.prefill(tp, _t(more), tc)
    _check(ref, got, "*=exact", "prefill")
    _check_cache(jc, tc)
    if per_slot:
        pos = np.array([8, 9], np.int32)
        jc = dict(jc, pos=jnp.asarray(pos))
        tc = dict(tc, pos=torch.from_numpy(pos))
    assert np.asarray(jc["pos"]).max() >= 8
    nxt = _tokens(2, 1, seed=5)
    ref, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
    got, tc = tm.decode_step(tp, _t(nxt), tc)
    _check(ref, got, "*=exact", "decode_step")
    _check_cache(jc, tc)


def test_decode_equals_forward_inside_the_port(np_params):
    """Exact f32: prefill + greedy decode gives the tokens, and the last
    logits, of a full-sequence forward over the same tokens."""
    _, _, tm, tp = _models("*=exact", np_params)
    toks = _t(_tokens(2, 4, seed=6))
    cache = tm.init_cache(2, 12)
    logits, cache = tm.prefill(tp, toks, cache)
    seq = toks
    for _ in range(6):
        nxt = logits[:, -1:].argmax(-1)
        seq = torch.cat([seq, nxt], 1)
        logits, cache = tm.decode_step(tp, nxt, cache)
    full, _ = tm.forward(tp, {"tokens": seq})
    torch.testing.assert_close(logits[:, -1], full[:, -1], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(full[:, 3:-1].argmax(-1), seq[:, 4:])


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
def test_paged_verify_step_matches_jax_exactly(spec, np_params):
    """One verify window of k = 3 drafts over block tables (rows at offsets
    0 and 5, the second with an unmapped page): the per-position greedy
    tokens and the accepted-draft counts equal JAX's. The drafts are JAX's
    own greedy tokens with one changed, so the rows accept 2 and 0."""
    jm, jp, tm, tp = _models(spec, np_params)
    bs, nb = 4, 8
    jkv, tkv = jm.init_paged_cache(nb, bs), tm.init_paged_cache(nb, bs)
    tables = np.array([[0, 1, 2, -1], [3, 4, 5, -1]], np.int32)
    pos = np.array([0, 5], np.int32)
    prompt = _tokens(2, 5, seed=7)
    jcache = dict(jkv, block_tables=jnp.asarray(tables),
                  pos=jnp.asarray([0, 0], jnp.int32))
    tcache = dict(tkv, block_tables=torch.from_numpy(tables),
                  pos=torch.zeros(2, dtype=torch.int32))
    _, jkv = jm.paged_step(jp, jnp.asarray(prompt), jcache, block_size=bs)
    _, tkv = tm.paged_step(tp, _t(prompt), tcache, block_size=bs)
    window = np.concatenate([prompt[:, -1:], _tokens(2, 3, seed=8)], 1)
    jcache = dict(jkv, block_tables=jnp.asarray(tables),
                  pos=jnp.asarray(pos))
    for j in range(3):  # JAX's greedy chain, one more position each pass
        greedy, _, _ = jm.paged_verify_step(jp, jnp.asarray(window), jcache,
                                            block_size=bs)
        window[:, j + 1] = np.asarray(greedy)[:, j]
    drafts = window[:, 1:].copy()
    drafts[0, 2] = (drafts[0, 2] + 1) % 128   # row 0 accepts 2
    drafts[1, 0] = (drafts[1, 0] + 1) % 128   # row 1 accepts 0
    window = np.concatenate([window[:, :1], drafts], 1).astype(np.int32)
    jcache = dict(jcache, k=jkv["k"], v=jkv["v"])
    tcache = dict(tkv, block_tables=torch.from_numpy(tables),
                  pos=torch.from_numpy(pos))
    jg, jn, _ = jm.paged_verify_step(jp, jnp.asarray(window), jcache,
                                     block_size=bs)
    tg, tn, _ = tm.paged_verify_step(tp, _t(window), tcache, block_size=bs)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tn.numpy(), [2, 0])


def test_steps_decode_step_equals_model_decode_step(np_params):
    """``build_artifacts(...).decode_step`` is ``model.decode_step`` under
    ``torch.no_grad()`` on a cache from ``init_cache``."""
    tcfg = tget("tinyllama_1_1b").smoke(**F32)
    art = build_artifacts(tcfg, device="cpu")
    params = params_from_jax(np_params, tcfg, device="cpu")
    toks = _tokens(2, 1, seed=9)
    c1, c2 = art.init_cache(2, 8), art.model.init_cache(2, 8)
    got, c1 = art.decode_step(params, toks, c1)
    ref, c2 = art.model.decode_step(params, _t(toks), c2)
    assert not got.requires_grad
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert int(c1["pos"]) == int(c2["pos"]) == 1
    torch.testing.assert_close(c1["k"], c2["k"], rtol=0, atol=0)
