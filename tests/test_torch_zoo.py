"""Port parity: the decoder-only zoo's dense ids (Gemma-2B, StarCoder2-15B,
Nemotron-4-340B) against the JAX ``DecoderLM`` on converted weights
(``forward``), every zoo id's parameter tree at full size, and flash
attention at the zoo's head dims (192, 256). Their slot-cache, paged and
train steps are in tests/test_torch_zoo_steps.py, Llama-3.2-Vision in
tests/test_torch_zoo_vlm.py, the MoE ids in tests/test_torch_moe.py.

Each id runs at ``get_config(id).smoke()`` (2 layers) with the same
numpy-seeded tokens on both sides.

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
  every row whose top-2 gap exceeds the bound (f32: on every row);
* flash's plain version against the interpreted Pallas kernel: the bounds
  of tests/test_torch_flash.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
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


ZOO = ("gemma_2b", "starcoder2_15b", "nemotron_4_340b", "dbrx_132b",
       "qwen3_moe_235b", "llama_3_2_vision_11b")
DENSE = ("gemma_2b", "starcoder2_15b", "nemotron_4_340b")
TESTED = DENSE
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
BF16 = dict(n_layers=2, vocab=128)
SPECS = ["*=exact", "*=pc3_tr", "*/attn/*=exact,*=pc3_tr"]
# (arch, entry point, spec) -> bound on max|dlogits| / max|ref|; the
# measured port-vs-JAX gap in the comment
APPROX_REL = {
    ("gemma_2b", "forward", "*=pc3_tr"): 1e-2,                   # 6.71e-3
    ("gemma_2b", "forward", "*/attn/*=exact,*=pc3_tr"): 3e-5,    # 1.8e-5
    ("starcoder2_15b", "forward", "*=pc3_tr"): 7.5e-3,           # 4.79e-3
    ("starcoder2_15b", "forward", "*/attn/*=exact,*=pc3_tr"): 7e-4,  # 4.68e-4
    ("nemotron_4_340b", "forward", "*=pc3_tr"): 6e-3,            # 3.79e-3
    ("nemotron_4_340b", "forward", "*/attn/*=exact,*=pc3_tr"): 3.5e-5,  # 2.3e-5
}
# bf16 ``*=pc3_tr:pallas`` (the kernel's plain version here) against JAX's
# jnp backend, forward: max|dlogits| / max|ref| (measured in the comments)
BF16_REL = {"gemma_2b": 4.5e-2,          # 2.99e-2
            "starcoder2_15b": 9e-2,      # 5.9e-2
            "nemotron_4_340b": 0.1}      # 6.92e-2


def _smoke(get, arch, kw, spec=None):
    cfg = get(arch).smoke(**kw)
    return cfg.with_policy(spec) if spec else cfg


@pytest.fixture(scope="module")
def np_params():
    """The JAX package's smoke params of each dense id, f32 and bf16 (its
    own init at each dtype)."""
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


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


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
# parameter trees at full size (all six ids; no allocation)
# ---------------------------------------------------------------------------

# the published counts of tests/test_models.py::test_full_size_param_counts
PUBLISHED_B = {"gemma_2b": 2.51, "starcoder2_15b": 15.96,
               "nemotron_4_340b": 341.0, "dbrx_132b": 131.6,
               "qwen3_moe_235b": 235.1, "llama_3_2_vision_11b": 11.5}


@pytest.mark.parametrize("arch", ZOO)
def test_param_specs_at_full_size_equal_the_reference(arch):
    """``param_specs`` at the published config: the reference's abstract
    init's paths, shapes and dtypes, and its published count (within 2%,
    as the reference's test holds it); a ``meta`` trace needs nothing
    more."""
    jshapes, _ = jbuild(jget(arch)).init(jax.random.PRNGKey(0), abstract=True)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    specs = tbuild(tget(arch), device="cpu").param_specs()
    assert {p: (tuple(s), str(np.dtype(jnp.dtype(d))))
            for p, (s, d, _) in specs.items()} == \
        {p: (tuple(leaf.shape), str(leaf.dtype)) for p, leaf in jflat.items()}
    n = sum(int(np.prod(s)) for s, _, _ in specs.values())
    assert n == sum(int(np.prod(leaf.shape)) for leaf in jflat.values())
    assert abs(n / 1e9 - PUBLISHED_B[arch]) / PUBLISHED_B[arch] < 0.02


@pytest.mark.parametrize("arch", TESTED)
def test_params_from_jax_and_own_init_cover_every_path(arch, np_params):
    for key, kw in (("f32", F32), ("bf16", BF16)):
        cfg = _smoke(tget, arch, kw)
        tp = flatten(params_from_jax(np_params[(arch, key)], cfg,
                                     device="cpu"))
        own = flatten(tbuild(cfg, device="cpu").init(0))
        assert {p: (tuple(t.shape), t.dtype) for p, t in own.items()} == \
            {p: (tuple(t.shape), t.dtype) for p, t in tp.items()}


# ---------------------------------------------------------------------------
# forward, decode_step, paged_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", TESTED)
def test_forward_matches_jax_f32(arch, spec, np_params):
    jm, jp, tm, tp = _models(arch, spec, "f32", np_params)
    toks = _tokens(2, 12)
    ref, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
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
    toks = _tokens(2, 12, seed=2)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    bound = BF16_REL[arch] * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.sum() >= 1
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# flash attention at the zoo's head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("variant", [None, Variant.PC3_TR])
def test_flash_plain_matches_pallas_at_large_head_dims(d, variant):
    """The flash plain version at Nemotron-4's D = 192 and Gemma's 256
    against the interpreted Pallas kernel, causal over two KV tiles: exact
    f32 within 1e-5, approximate bf16 within the JAX suite's 2e-2 (the
    bounds of tests/test_torch_flash.py; measured 3.6e-7 and 2.4e-4)."""
    rng = np.random.default_rng(d)
    dt = np.float32 if variant is None else jnp.bfloat16
    q, k, v = (rng.normal(size=(2, 256, d)).astype(np.float32)
               for _ in range(3))
    jv = None if variant is None else JVariant(variant.value)
    ref = jflash(*(jnp.asarray(t, dt) for t in (q, k, v)), causal=True,
                 variant=jv, interpret=True)
    tdt = torch.float32 if variant is None else torch.bfloat16
    got = flash_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                          causal=True, variant=variant)
    err = np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max()
    assert err <= (1e-5 if variant is None else 2e-2), err


def test_zoo_ids_are_ported_and_build():
    """``get_config`` returns every zoo id (aliases too) and
    ``build_model`` builds it (default device: the card)."""
    for arch in ZOO:
        cfg = tget(arch.replace("_", "-"))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tget(arch))
        assert tbuild(cfg, device="cpu").cfg is cfg


def test_tied_lm_head_transpose_is_taken_once_per_embedding():
    """Gemma's tied lm_head: ``embedding.T`` is copied once and kept on the
    embedding tensor, copied again after an in-place write to it, and at
    every call while it takes gradients; the bits are those of a fresh
    ``e.t().contiguous()`` every time."""
    from repro_torch.models.layers import tied_lm_head

    e = torch.randn((64, 16))
    first = tied_lm_head(e)
    assert tied_lm_head(e) is first
    assert torch.equal(first, e.t().contiguous()) and first.is_contiguous()
    with torch.no_grad():
        e.add_(1.0)
    second = tied_lm_head(e)
    assert second is not first and torch.equal(second, e.t().contiguous())
    e.requires_grad_(True)
    assert tied_lm_head(e) is not tied_lm_head(e)
    with torch.inference_mode():
        f = torch.randn((8, 4))
    assert tied_lm_head(f) is tied_lm_head(f)
