"""Port parity: DAISM numerics of repro_torch.core against repro.core.

Same inputs (numpy, seeded) through the JAX function and the port; every
product must be bit-identical (int32 views equal)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitops as jbitops  # noqa: E402
from repro.core import floatmul as jfloatmul  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import multiplier as jmult  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.kernels import approx_product as japprox  # noqa: E402
from repro_torch.core import bitops, floatmul, lut, multiplier  # noqa: E402
from repro_torch.core.config import ALL_VARIANTS, Variant  # noqa: E402
from repro_torch.kernels import approx_product  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VARIANTS = [v.value for v in ALL_VARIANTS]


def _bf16_pairs(seed):
    """Every (mx, mw) pair of normalized bf16 mantissas, random signs and
    exponents whose sums include underflow (<= 0) and overflow (>= 255)."""
    rng = np.random.default_rng(seed)
    frac = np.arange(128)
    fx, fw = np.meshgrid(frac, frac, indexing="ij")

    def pack(f):
        e = rng.integers(1, 255, size=f.shape)
        s = rng.integers(0, 2, size=f.shape)
        return ((s << 15) | (e << 7) | f).astype(np.uint16)

    xb, wb = pack(fx).ravel(), pack(fw).ravel()
    # pin some exponent pairs to the flush / saturate edges and add zeros
    # and subnormals
    xb[:64] = (xb[:64] & 0x807F) | (1 << 7)
    wb[:64] = (wb[:64] & 0x807F) | (60 << 7)
    xb[64:128] = (xb[64:128] & 0x807F) | (254 << 7)
    wb[64:128] = (wb[64:128] & 0x807F) | (200 << 7)
    xb[128:132] = [0, 0x8000, 1, 0x807F]
    return xb, wb


def _jbf16(bits):
    return jnp.asarray(bits).view(jnp.bfloat16)


def _tbf16(bits):
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).numpy()
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_products_bit_identical(variant):
    xb, wb = _bf16_pairs(0)
    ref = jfloatmul.approx_mul_to_f32(_jbf16(xb), _jbf16(wb), JVariant(variant))
    got = floatmul.approx_mul_to_f32(_tbf16(xb), _tbf16(wb), Variant(variant))
    r = np.asarray(ref)
    assert np.isinf(r).any() and (r == 0).any()  # the edges were reached
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("variant", VARIANTS)
def test_f32_products_bit_identical(variant):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=3000) * 2.0 ** rng.integers(-140, 120, 3000)).astype(
        np.float32)
    w = (rng.normal(size=3000) * 2.0 ** rng.integers(-100, 100, 3000)).astype(
        np.float32)
    x[:6] = [0.0, -0.0, 1e-45, -3e-39, 3e38, -1.7e38]
    ref = jfloatmul.approx_mul_to_f32(jnp.asarray(x), jnp.asarray(w),
                                      JVariant(variant))
    got = floatmul.approx_mul_to_f32(torch.from_numpy(x), torch.from_numpy(w),
                                     Variant(variant))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("variant", VARIANTS)
def test_mantissa_product_table_and_shrinkage_equal(variant):
    np.testing.assert_array_equal(
        lut.mantissa_product_table(Variant(variant)),
        jlut.mantissa_product_table(JVariant(variant)))
    assert lut.shrinkage_factor(Variant(variant)) == \
        jlut.shrinkage_factor(JVariant(variant))


@pytest.mark.parametrize("variant", VARIANTS)
def test_lut_products_bit_identical(variant):
    xb, wb = _bf16_pairs(2)
    ref = jlut.approx_mul_to_f32_lut(_jbf16(xb), _jbf16(wb), JVariant(variant))
    got = lut.approx_mul_to_f32_lut(_tbf16(xb), _tbf16(wb), Variant(variant))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("variant", VARIANTS)
def test_tile_primitives_bit_identical(variant):
    """The plain twin of the CUDA header against the Pallas primitives."""
    xb, wb = _bf16_pairs(3)
    ref = japprox.compose_products_f32(
        japprox.decompose_bf16_i32(_jbf16(xb)),
        japprox.decompose_bf16_i32(_jbf16(wb)), JVariant(variant))
    got = approx_product.compose_products_f32(
        approx_product.decompose_bf16_i32(_tbf16(xb)),
        approx_product.decompose_bf16_i32(_tbf16(wb)), Variant(variant))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("drop_lsb", [True, False])
@pytest.mark.parametrize("variant", [v.value for v in Variant])
def test_integer_single_word_matches(variant, drop_lsb):
    """Integer mode, n = 8, every operand pair (the INT8 error study)."""
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ref = jmult.approx_mul_uint(jnp.asarray(a), jnp.asarray(b), 8,
                                JVariant(variant), integer_drop_lsb=drop_lsb)
    got = multiplier.approx_mul_uint(torch.from_numpy(a), torch.from_numpy(b), 8,
                                     Variant(variant),
                                     integer_drop_lsb=drop_lsb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", [v.value for v in Variant])
def test_shift_normalized_product_matches(variant):
    """Paper Eq. (3) shift normalization, n = 8, every operand pair: the
    int32 results equal the JAX package's, dtype included."""
    a, b = np.meshgrid(np.arange(256, dtype=np.int32),
                       np.arange(256, dtype=np.int32), indexing="ij")
    ref = np.asarray(jmult.approx_mul_uint_normalized(
        jnp.asarray(a), jnp.asarray(b), 8, JVariant(variant)))
    got = multiplier.approx_mul_uint_normalized(
        torch.from_numpy(a), torch.from_numpy(b), 8, Variant(variant)).numpy()
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("drop_lsb", [True, False])
@pytest.mark.parametrize("variant", [v.value for v in Variant])
def test_signmag_product_matches(variant, drop_lsb):
    """Sign-magnitude signed products, every pair of 8-bit magnitudes with
    both signs (-255 .. 255): equal to the JAX package's."""
    vals = np.arange(-255, 256, dtype=np.int32)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    ref = np.asarray(jmult.approx_mul_int_signmag(
        jnp.asarray(a), jnp.asarray(b), 8, JVariant(variant),
        integer_drop_lsb=drop_lsb))
    got = multiplier.approx_mul_int_signmag(
        torch.from_numpy(a), torch.from_numpy(b), 8, Variant(variant),
        integer_drop_lsb=drop_lsb).numpy()
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("variant", [v.value for v in Variant])
def test_dual_plane_matches(variant):
    """n = 24 (f32 mantissas) in both integer and float mode."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 24, size=5000)
    b = rng.integers(0, 1 << 24, size=5000)
    for msb in (False, True):
        bb = b | (1 << 23) if msb else b
        rh, rl = jmult.approx_mul_uint_planes(
            jnp.asarray(a), jnp.asarray(bb), 24, JVariant(variant),
            msb_always_set=msb)
        gh, gl = multiplier.approx_mul_uint_planes(
            torch.from_numpy(a), torch.from_numpy(bb), 24, Variant(variant),
            msb_always_set=msb)
        np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))


def test_bf16_compose_roundtrip_matches():
    xb, _ = _bf16_pairs(5)
    s, e, m = jbitops.decompose_bf16(_jbf16(xb))
    ts, te, tm = bitops.decompose_bf16(_tbf16(xb))
    for j, t in ((s, ts), (e, te), (m, tm)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    ref = jbitops.compose_bf16(s, e + 1, m)
    got = bitops.compose_bf16(ts, te + 1, tm)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
