"""Port parity: flash attention (repro_torch.kernels.flash_attention, the
``:flash`` policy path, cross attention) against the JAX package.

The JAX kernel runs in interpret mode, as its own tests run it on the CPU;
the port's entry points run the CUDA kernel's plain version on CPU tensors.
Both walk the same KV tiles in the same order, so they differ only where
the two frameworks round apart. Tolerances:

* exact, f32: atol 1e-5 (same tiles; only the f32 summation order of the
  dots and row sums differs; measured <= 6e-7);
* exact, bf16 inputs: one bf16 ulp of the output (rtol 2**-7, the ulp of
  a mantissa near 1.0, plus 1e-6): the f32 results agree as above and are
  then rounded to bf16 once, which can land them one ulp apart;
* approximate (bf16): atol 2e-2, the JAX suite's bound for one KV tile,
  for one tile and several alike: the tile sequence is the same, so the
  only slack is the f32 summation order and the last ulp of exp, which can
  round a p to its neighbouring bf16 and move that approximate PV product
  by up to ~2**-3 of itself (measured <= 9.8e-4, on one element).
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.module import Ctx as JCtx  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import DaismConfig, Variant  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.module import Ctx as TCtx  # noqa: E402
from repro_torch.policy import dispatch  # noqa: E402

# the module (repro.kernels re-exports a function of the same name)
jfa = importlib.import_module("repro.kernels.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


APPROX_ATOL = 2e-2
# bf16 approximate layer bound: tests/test_torch_model.py's reasoning and
# bound for a whole bf16 approximate forward (BF16_REL there)
BF16_REL = 0.11


def _t(x):
    """A JAX array as a torch tensor with the same bits (bf16 included)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _qkv(q_shape, kv_shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.normal(size=s), dtype)
                 for s in (q_shape, kv_shape, kv_shape))


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _bf16_close(got, ref):
    got, ref = _f32(got), _f32(ref)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, rtol=2**-7, atol=1e-6)


SHAPES = [  # (B, Sq, Skv, H, KH, D): tests/test_flash_attention.py's
    (2, 128, 128, 4, 2, 64),
    (1, 256, 256, 2, 2, 128),
    (2, 100, 100, 4, 1, 32),   # ragged -> pad path
    (1, 64, 64, 8, 8, 16),     # MHA
]


@pytest.mark.parametrize("shape", SHAPES)
def test_exact_f32_matches_jax(shape):
    b, sq, skv, h, kh, d = shape
    q, k, v = _qkv((b, sq, h, d), (b, skv, kh, d), jnp.float32, sum(shape))
    ref = jfa.flash_attention_bhsd(q, k, v, block_q=64, block_k=64,
                                   interpret=True)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), block_q=64,
                                   block_k=64)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant,causal,s,block", [
    ("pc3_tr", True, 128, 128),    # one KV tile
    ("pc3_tr", True, 256, 128),    # two tiles of the default width
    ("fla", False, 128, 128),
    ("fla", False, 128, 64),       # two narrower tiles
])
def test_approx_matches_jax(variant, causal, s, block):
    q, k, v = _qkv((2, s, 64), (2, s, 64), jnp.bfloat16, 5)
    ref = jfa.flash_attention(q, k, v, causal=causal, variant=JVariant(variant),
                              block_q=block, block_k=block, interpret=True)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              variant=Variant(variant), block_q=block,
                              block_k=block)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=0, atol=APPROX_ATOL)


@pytest.mark.parametrize("variant", [None, "pc3_tr"])
def test_ragged_non_causal_matches_jax(variant):
    """Both lengths ragged (Sq=100, Skv=72), grouped-query heads: padded
    keys are masked through kv_len, padded query rows dropped."""
    q, k, v = _qkv((2, 100, 4, 64), (2, 72, 2, 64), jnp.bfloat16, 11)
    jv = variant and JVariant(variant)
    ref = jfa.flash_attention_bhsd(q, k, v, causal=False, variant=jv,
                                   interpret=True)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), causal=False,
                                   variant=variant and Variant(variant))
    assert tuple(got.shape) == (2, 100, 4, 64)
    if variant is None:
        _bf16_close(got, ref)
    else:
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=APPROX_ATOL)


def test_fully_masked_causal_tiles_match_jax():
    """Blocks of 32 keys make whole tiles causally masked (query tile 0 x
    every later KV tile): they contribute nothing, not NaN."""
    q, k, v = _qkv((2, 128, 2, 32), (2, 128, 2, 32), jnp.bfloat16, 3)
    ref = jfa.flash_attention_bhsd(q, k, v, causal=True, block_q=32,
                                   block_k=32, interpret=True)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), causal=True,
                                   block_q=32, block_k=32)
    _bf16_close(got, ref)


def test_kv_len_one_masks_every_later_key():
    """kv_len = 1 with causal masking: every row sees key 0 only, so every
    later lane and every later tile is masked (p zeroed) and the output is
    v[:, 0] for each row, as in the reference."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 64, 16)).astype(
        np.float32)) for _ in range(3))
    out = tfa.flash_attention(q, k, v, causal=True, kv_len=1, block_q=32,
                              block_k=32)
    torch.testing.assert_close(out, v[:, :1].expand_as(out), rtol=0, atol=1e-6)
    ref = jfa.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(v.numpy()), causal=True, kv_len=1,
                              block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_gqa_approx_matches_jax_wrapper():
    """8 query heads over 2 kv heads, padded to one tile, approximate."""
    q, k, v = _qkv((1, 96, 8, 32), (1, 96, 2, 32), jnp.bfloat16, 4)
    ref = jfa.flash_attention_bhsd(q, k, v, variant=JVariant.PC3_TR,
                                   interpret=True)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), variant=Variant.PC3_TR)
    np.testing.assert_allclose(_f32(got), _f32(ref), atol=APPROX_ATOL)


def _tensor_core_exact_emulation(q, k, v, *, causal, split_p=True):
    """The arithmetic of csrc/flash_attention.cu's tensor-core exact kernel
    (flash_fwd_tc) in torch, on (B, S, H, D) bf16 tensors: 128-key tiles in
    ascending order; scores as f32 sums of the exact f32 products of the
    bf16 values; an f32 online softmax; p split into p_hi = bf16(p) and
    p_lo = bf16(p - p_hi), and PV as p_hi v + p_lo v; o rounded to bf16.
    ``split_p=False`` drops p_lo: one bf16 p, the design the split avoids."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    qf, kf, vf = (t.transpose(1, 2).float() for t in (q, k, v))  # (B, H, S, D)
    scale = tfa._scale(d)
    q_pos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), -float("inf"))
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, tfa.KERNEL_BLOCK_K):
        kt = kf[:, :, k0:k0 + tfa.KERNEL_BLOCK_K]
        vt = vf[:, :, k0:k0 + tfa.KERNEL_BLOCK_K]
        s = (qf @ kt.transpose(-1, -2)) * scale
        k_pos = k0 + torch.arange(kt.shape[2])[None, :]
        mask = k_pos <= q_pos if causal else torch.ones_like(s, dtype=bool)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float() if split_p else 0.0 * p
        acc = acc * corr[..., None] + p_hi @ vt + p_lo @ vt
        m = m_new
    out = (acc / l.clamp(min=1e-30)[..., None]).to(torch.bfloat16)
    return out.transpose(1, 2)


TENSOR_CORE_SHAPES = [
    ((1, 256, 256, 4, 2, 64), True),    # GQA, two KV tiles
    ((1, 256, 256, 4, 2, 64), False),
    ((2, 200, 200, 2, 2, 40), True),    # D = 40: not a multiple of 16
    ((1, 100, 300, 4, 1, 16), False),   # ragged, MQA, a partial KV tile
]


@pytest.mark.parametrize("shape,causal", TENSOR_CORE_SHAPES)
def test_tensor_core_exact_design_matches_interpreted_pallas(shape, causal):
    """The numeric design of the exact tensor-core kernel, before any card
    runs it: within the JAX suite's exact bound (2e-3 + 2e-2 |ref|) of the
    reference's interpreted Pallas kernel (exact mode, bf16 inputs, 128-key
    tiles). The split p keeps ~16 mantissa bits, so the design also stays
    within one bf16 ulp (2**-7 |plain| + 1e-6) of the plain version, which
    multiplies the f32 p."""
    b, sq, skv, h, kh, d = shape
    q, k, v = _qkv((b, sq, h, d), (b, skv, kh, d), jnp.bfloat16, 13)
    ref = jfa.flash_attention_bhsd(q, k, v, causal=causal, interpret=True)
    got = _tensor_core_exact_emulation(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=2e-2, atol=2e-3)
    plain = tfa.flash_attention_bhsd_plain(_t(q), _t(k), _t(v), causal=causal)
    _bf16_close(got, plain)


@pytest.mark.parametrize("shape,causal", TENSOR_CORE_SHAPES)
def test_one_bf16_p_breaks_the_one_rounding_bound(shape, causal):
    """A control for the bound chip_smoke.py holds the card's tensor-core
    kernel to, 2**-7 |plain| + 2**-16 max|v| (one bf16 rounding, and p kept
    to 2**-16 of itself by the split): the same arithmetic with p rounded
    once to bf16 (2**-8 of p) leaves the plain version by more."""
    b, sq, skv, h, kh, d = shape
    q, k, v = _qkv((b, sq, h, d), (b, skv, kh, d), jnp.bfloat16, 13)
    got = _tensor_core_exact_emulation(_t(q), _t(k), _t(v), causal=causal,
                                       split_p=False)
    plain = tfa.flash_attention_bhsd_plain(_t(q), _t(k), _t(v), causal=causal)
    bound = 2.0**-7 * np.abs(_f32(plain)) + 2.0**-16 * np.abs(_f32(_t(v))).max()
    assert (np.abs(_f32(got) - _f32(plain)) > bound).any()


def test_bf16_only_error_text_matches_jax():
    q = jnp.ones((1, 128, 16), jnp.float32)
    with pytest.raises(ValueError) as jerr:
        jfa.flash_attention(q, q, q, variant=JVariant.PC3_TR, interpret=True)
    tq = torch.ones((1, 128, 16))
    with pytest.raises(ValueError) as terr:
        tfa.flash_attention(tq, tq, tq, variant=Variant.PC3_TR)
    assert str(terr.value) == str(jerr.value)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The CUDA wrapper never computes on the CPU: it raises, and its launch
    counter does not move; the entry point takes the plain version."""
    q = torch.zeros((1, 128, 16))
    before = tfa.launches
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_kernel(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_bhsd_kernel(q[None], q[None], q[None])
    tfa.flash_attention(q, q, q)
    assert tfa.launches == before


# ---------------------------------------------------------------------------
# dispatch.attention_kernel
# ---------------------------------------------------------------------------


def test_attention_kernel_one_callable_per_config():
    cfg = DaismConfig(variant=Variant.PC3_TR, attn_kernel="flash")
    builds = dispatch._STATS["kernel_builds"]
    fn = dispatch.attention_kernel(cfg)
    assert dispatch.attention_kernel(cfg.replace()) is fn
    assert dispatch._STATS["kernel_builds"] == builds + 1
    other = dispatch.attention_kernel(cfg.replace(variant=Variant.FLA))
    assert other is not fn
    q = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 16, 2, 16)).astype(np.float32)).to(torch.bfloat16)
    calls = dispatch._STATS["attention_calls"]
    out = fn(q, q, q, True)
    assert dispatch._STATS["attention_calls"] == calls + 1
    torch.testing.assert_close(
        out, tfa.flash_attention_bhsd(q, q, q, variant=Variant.PC3_TR),
        rtol=0, atol=0)


def test_attention_kernel_raises_under_autograd():
    """The reference's flash kernel has no backward (jax.grad fails on its
    pallas_call); the port raises instead of inventing one."""
    fn = dispatch.attention_kernel(DaismConfig(variant=Variant.EXACT,
                                               attn_kernel="flash"))
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(q, q, q, True)
    with torch.no_grad():
        assert fn(q, q, q, True).shape == q.shape


# ---------------------------------------------------------------------------
# cross attention and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,dtype", [("*=exact:flash", "float32"),
                                        ("*=pc3_tr:flash", "bfloat16")])
def test_cross_attention_matches_jax(spec, dtype):
    """Non-causal, Skv != Sq, grouped-query heads: the kernel's only
    ragged-KV caller in the JAX package, routed through ``:flash``."""
    jcfg = jget("tinyllama_1_1b").smoke(
        param_dtype=dtype, compute_dtype=dtype).with_policy(spec)
    tcfg = tget("tinyllama_1_1b").smoke(
        param_dtype=dtype, compute_dtype=dtype).with_policy(spec)
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.normal(size=(2, 20, 64)), dtype)
    src = jnp.asarray(rng.normal(size=(2, 40, 64)), dtype)
    ictx = JCtx("init", rng=jax.random.PRNGKey(1))
    with ictx.scope("cross"):
        jlayers.cross_attention(ictx, x, src, jcfg)
    actx = JCtx("apply", ictx.params)
    with actx.scope("cross"):
        ref = jlayers.cross_attention(actx, x, src, jcfg)
    tparams = jax.tree.map(_t, ictx.params)
    calls = dispatch._STATS["attention_calls"]
    tctx = TCtx(tparams)
    with tctx.scope("cross"):
        got = tlayers.cross_attention(tctx, _t(x), _t(src), tcfg)
    assert dispatch._STATS["attention_calls"] == calls + 1  # through flash
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-4, atol=1e-4)
    else:  # bf16 approximate GEMMs and attention; measured gap 0.0
        assert np.abs(_f32(got) - _f32(ref)).max() <= \
            BF16_REL * np.abs(_f32(ref)).max()
