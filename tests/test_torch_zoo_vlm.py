"""Port parity: Llama-3.2-Vision's cross blocks against the JAX
``DecoderLM`` on converted weights: ``forward``, ``prefill``/``decode_step``
with image embeddings and the paged cache's refusal (smoke config: 2
layers, a cross block after each 2; 8 image tokens; its cross blocks'
site paths and train step are in tests/test_torch_zoo_vlm_train.py).

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


VLM = "llama_3_2_vision_11b"
TESTED = (VLM,)
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
BF16 = dict(n_layers=2, vocab=128)
SPECS = ["*=exact", "*=pc3_tr", "*/attn/*=exact,*=pc3_tr"]
# (arch, entry point, spec) -> bound on max|dlogits| / max|ref|; the
# measured port-vs-JAX gap in the comment
APPROX_REL = {
    (VLM, "forward", "*=pc3_tr"): 3e-2,                          # 2.05e-2
    (VLM, "forward", "*/attn/*=exact,*=pc3_tr"): 4.5e-2,         # 3.04e-2
}
# bf16 ``*=pc3_tr:pallas`` (the kernel's plain version here) against JAX's
# jnp backend, forward: max|dlogits| / max|ref| (measured in the comments)
BF16_REL = {VLM: 0.15}                   # 0.102


def _smoke(get, arch, kw, spec=None):
    cfg = get(arch).smoke(**kw)
    return cfg.with_policy(spec) if spec else cfg


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's smoke params, f32 and bf16 (its own init at each
    dtype)."""
    out = {}
    for arch in TESTED:
        for key, kw in (("f32", F32), ("bf16", BF16)):
            p, _ = jbuild(_smoke(jget, arch, kw)).init(jax.random.PRNGKey(0))
            out[(arch, key)] = jax.tree.map(np.asarray, p)
    return out


def _models(arch, spec, key, np_params, port_spec=None):
    kw = F32 if key == "f32" else BF16
    jm = jbuild(_smoke(jget, arch, kw, spec))
    tcfg = _smoke(tget, arch, kw, port_spec or spec)
    tm = tbuild(tcfg, device="cpu")
    p = np_params[(arch, key)]
    return (jm, jax.tree.map(jnp.asarray, p), tm,
            params_from_jax(p, tcfg, device="cpu"))


def _batch(cfg, b, s, seed=0, dtype=np.float32):
    """Tokens (and a VLM's image embeddings) from a numpy seed, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(dtype)
    return batch


def _jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if k == "image_embeds" else None)
            for k, v in batch.items()}


def _torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if k == "image_embeds"
            else torch.from_numpy(v).long() for k, v in batch.items()}


def test_params_from_jax_and_own_init_cover_every_path(np_params):
    """The converted tree and the port's own init declare the same paths,
    shapes and dtypes, the stacked ``cross_blocks`` included."""
    for key, kw in (("f32", F32), ("bf16", BF16)):
        cfg = _smoke(tget, VLM, kw)
        tp = flatten(params_from_jax(np_params[(VLM, key)], cfg,
                                     device="cpu"))
        own = flatten(tbuild(cfg, device="cpu").init(0))
        assert {p: (tuple(t.shape), t.dtype) for p, t in own.items()} == \
            {p: (tuple(t.shape), t.dtype) for p, t in tp.items()}
        assert tp["cross_blocks/xattn/wk"].shape == (1, 64, 32)


def _check(ref, got, arch, spec, entry):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert got.shape == ref.shape
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        rel = APPROX_REL[(arch, entry, spec)]
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------------------------------
# forward, decode_step, paged_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", TESTED)
def test_forward_matches_jax_f32(arch, spec, np_params):
    jm, jp, tm, tp = _models(arch, spec, "f32", np_params)
    batch = _batch(tm.cfg, 2, 12)
    ref, jaux = jm.forward(jp, _jax(batch))
    with torch.no_grad():
        got, taux = tm.forward(tp, _torch(batch))
    _check(ref, got.numpy(), arch, spec, "forward")
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", TESTED)
def test_bf16_pallas_forward_matches_jax(arch, np_params):
    """bf16 ``*=pc3_tr:pallas`` (the kernel's plain version on the CPU)
    against JAX's ``*=pc3_tr`` (jnp backend, the same function): within
    ``BF16_REL``, greedy tokens equal on every row whose top-2 gap exceeds
    the bound (at least one such row: with 128 random logits a row the
    bound leaves clear is rarer than in tests/test_torch_model.py)."""
    jm, jp, tm, tp = _models(arch, "*=pc3_tr", "bf16", np_params,
                             port_spec="*=pc3_tr:pallas")
    batch = _batch(tm.cfg, 2, 12, seed=2)
    ref, _ = jm.forward(jp, _jax(batch, jnp.bfloat16))
    with torch.no_grad():
        got, _ = tm.forward(tp, _torch(batch, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    bound = BF16_REL[arch] * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.sum() >= 1
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


# decode_step: (arch, spec) -> bound as above (prefill of 2 x 5 tokens,
# then 5 greedy decode steps; measured in the comments)
DECODE_REL = {
    (VLM, "*=pc3_tr"): 4.5e-2,                               # 2.94e-2
}


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
@pytest.mark.parametrize("arch", TESTED)
def test_prefill_then_decode_matches_jax(arch, spec, np_params):
    """``prefill`` of 5 tokens then 5 greedy ``decode_step``s on a slot
    cache, the VLM's with its image embeddings at every step; the port
    feeds JAX's greedy tokens so both see the same sequence."""
    jm, jp, tm, tp = _models(arch, spec, "f32", np_params)
    batch = _batch(tm.cfg, 2, 5, seed=3)
    jimg = _jax(batch).get("image_embeds")
    timg = _torch(batch).get("image_embeds")
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jl, jc = jm.prefill(jp, jnp.asarray(batch["tokens"]), jc,
                        image_embeds=jimg)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(batch["tokens"]).long(), tc,
                            image_embeds=timg)
    refs, gots = [np.asarray(jl)], [tl.numpy()]
    nxt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, image_embeds=jimg)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(nxt).long(), tc,
                                    image_embeds=timg)
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


def test_vlm_refuses_the_paged_cache_as_the_reference_does(np_params):
    jm, _, tm, _ = _models(VLM, "*=exact", "f32", np_params)
    with pytest.raises(NotImplementedError, match="VLM cross-attention"):
        jm.init_paged_cache(4, 8)
    with pytest.raises(NotImplementedError, match="VLM cross-attention"):
        tm.init_paged_cache(4, 8)
