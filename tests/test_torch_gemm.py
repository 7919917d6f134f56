"""Port parity: the approximate GEMM (repro_torch.core.gemm, the kernel
wrapper and its plain version) against the JAX package.

The ``pallas`` spelling runs the CUDA kernel's plain version on CPU tensors.
It is held against ``repro.kernels.ref.daism_matmul_ref`` over
tests/test_kernels.py's variant x shape sweep, and against the Pallas
kernel itself (interpret mode, ~2 s a call here) on the ragged shape and a
multi-tile K shape, for one variant of each line structure. The kernel
on the card is held against the same plain version by chip_smoke.py and by tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import gemm as jgemm  # noqa: E402
from repro.core.config import Backend as JBackend  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.kernels.ops import daism_matmul_pallas as jpallas  # noqa: E402
from repro.kernels.ref import daism_matmul_ref as jref  # noqa: E402
from repro_torch.core import gemm  # noqa: E402
from repro_torch.core.config import Backend, DaismConfig, Variant  # noqa: E402
from repro_torch.kernels import daism_matmul as dm  # noqa: E402
from repro_torch.kernels.ops import daism_matmul_pallas  # noqa: E402
from repro_torch.kernels.ref import daism_matmul_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VARIANTS = ["fla", "hla", "pc2", "pc3", "pc2_tr", "pc3_tr"]

SHAPES = [
    (8, 128, 128),     # exactly one Pallas tile
    (16, 128, 256),    # multi-tile N
    (24, 256, 128),    # multi-tile K
    (5, 70, 33),       # ragged
    (1, 1, 1),         # degenerate
]

# tests/test_kernels.py:41 — products are bit-identical, the reduction
# differs only in f32 summation order
RTOL, ATOL = 1e-5, 1e-4


def _data(m, k, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return a, w


def _bf16_pair(a, w):
    """The same bf16 operands for both packages (rounded once, by jax)."""
    ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ta = torch.from_numpy(np.asarray(ja).view(np.int16).copy()).view(
        torch.bfloat16)
    tw = torch.from_numpy(np.asarray(jw).view(np.int16).copy()).view(
        torch.bfloat16)
    return (ja, jw), (ta, tw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_pallas_spelling_matches_oracle(shape, variant):
    (ja, jw), (ta, tw) = _bf16_pair(*_data(*shape))
    got = daism_matmul_pallas(ta, tw, DaismConfig(variant=Variant(variant),
                                                  backend=Backend.PALLAS))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jref(ja, jw, JVariant(variant))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               daism_matmul_ref(ta, tw, Variant(variant)).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,variant",
                         [((5, 70, 33), v) for v in ("fla", "hla", "pc3_tr")]
                         + [((24, 256, 128), "pc2")])
def test_pallas_spelling_matches_interpreted_pallas_kernel(shape, variant):
    (ja, jw), (ta, tw) = _bf16_pair(*_data(*shape, seed=5))
    ref = jpallas(ja, jw, JConfig(variant=JVariant(variant),
                                  backend=JBackend.PALLAS, interpret=True))
    got = daism_matmul_pallas(ta, tw, DaismConfig(variant=Variant(variant),
                                                  backend=Backend.PALLAS))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_exact_plain_matches_matmul(shape):
    (ja, jw), (ta, tw) = _bf16_pair(*_data(*shape, seed=1))
    got = dm.daism_matmul_plain(ta, tw, Variant.EXACT)
    ref = np.asarray(ja, np.float32) @ np.asarray(jw, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["jnp", "lut"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_jnp_and_lut_backends_match_jax(backend, variant):
    (ja, jw), (ta, tw) = _bf16_pair(*_data(12, 150, 40, seed=2))
    jcfg = JConfig(variant=JVariant(variant), backend=JBackend(backend))
    tcfg = DaismConfig(variant=Variant(variant), backend=Backend(backend))
    ref = np.asarray(jgemm.daism_matmul(ja, jw, jcfg))
    np.testing.assert_allclose(gemm.daism_matmul(ta, tw, tcfg).numpy(), ref,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["fla", "pc3_tr"])
def test_f32_jnp_backend_and_calibration_match_jax(variant):
    a, w = _data(6, 100, 20, seed=3)
    for calibrated in (False, True):
        jcfg = JConfig(variant=JVariant(variant), calibrated=calibrated)
        tcfg = DaismConfig(variant=Variant(variant), calibrated=calibrated)
        ref = np.asarray(jgemm.daism_dot(jnp.asarray(a[None]), jnp.asarray(w),
                                         jcfg))
        got = gemm.daism_dot(torch.from_numpy(a[None]), torch.from_numpy(w),
                             tcfg)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_pallas_rejects_f32_operands():
    a = torch.zeros((8, 128))
    w = torch.zeros((128, 128))
    cfg = DaismConfig(variant=Variant.PC3_TR, backend=Backend.PALLAS)
    with pytest.raises(ValueError, match="bfloat16-only"):
        daism_matmul_pallas(a, w, cfg)
    with pytest.raises(ValueError, match="bfloat16-only"):
        gemm.daism_matmul(a, w, cfg)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The CUDA wrapper never computes on the CPU: it raises, and its launch
    counter does not move."""
    a = torch.zeros((4, 8), dtype=torch.bfloat16)
    before = dm.launches
    with pytest.raises(ValueError, match="CUDA device"):
        dm.daism_matmul_kernel(a, a.t().contiguous(), Variant.PC3_TR)
    dm.daism_matmul_plain(a, a.t().contiguous(), Variant.PC3_TR)
    assert dm.launches == before


def test_pallas_refuses_approx_backward():
    """The JAX package's pallas backend refuses backward='approx' at
    construction (its Pallas kernel has no backward); the port's config
    accepts the pair (see the next test)."""
    with pytest.raises(ValueError, match="no approximate backward"):
        JConfig(backend=JBackend.PALLAS, backward="approx")
    assert DaismConfig(backend=Backend.PALLAS, backward="approx").backward \
        == "approx"


def test_pallas_approx_backward_matches_jnp():
    """The port's pallas backward GEMMs launch the same CUDA kernel on
    transposed operands (on CPU tensors, the kernel's plain version); they
    give the jnp backend's approximate gradients, up to f32 summation
    order."""
    a, w = _data(6, 40, 9, seed=5)
    _, (ta, tw) = _bf16_pair(a, w)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(6, 9)).astype(
        np.float32))
    grads = {}
    for backend in (Backend.PALLAS, Backend.JNP):
        cfg = DaismConfig(variant=Variant.PC3_TR, backend=backend,
                          backward="approx")
        x, y = ta.clone().requires_grad_(), tw.clone().requires_grad_()
        (gemm.daism_matmul(x, y, cfg) * g).sum().backward()
        grads[backend] = (x.grad.float(), y.grad.float())
    for got, ref in zip(grads[Backend.PALLAS], grads[Backend.JNP]):
        torch.testing.assert_close(got, ref, rtol=2**-8, atol=0)


@pytest.mark.parametrize("backward", ["ste", "approx"])
def test_gradients_match_jax_grad(backward):
    a, w = _data(5, 24, 7, seed=4)
    g = np.random.default_rng(9).normal(size=(5, 7)).astype(np.float32)
    jcfg = JConfig(variant=JVariant.PC3_TR, backward=backward)
    jloss = lambda x, y: jnp.sum(jgemm.daism_matmul(x, y, jcfg) * g)  # noqa: E731
    jda, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(w))
    ta = torch.from_numpy(a).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tcfg = DaismConfig(variant=Variant.PC3_TR, backward=backward)
    (gemm.daism_matmul(ta, tw, tcfg) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jda), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# daism_matmul_ordered: the kernel's own summation order (chunks of KC)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 70, 33), (3, 200, 17), (4, 130, 40),
                                   (2, 64, 8)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ordered_oracle_matches_plain_and_jax_ref(shape, variant):
    """The same products as the plain version and JAX's oracle, added in
    another f32 order: tests/test_kernels.py:41's bounds."""
    (ja, jw), (ta, tw) = _bf16_pair(*_data(*shape, seed=7))
    got = dm.daism_matmul_ordered(ta, tw, Variant(variant)).numpy()
    np.testing.assert_allclose(
        got, dm.daism_matmul_plain(ta, tw, Variant(variant)).numpy(),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jref(ja, jw, JVariant(variant))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["fla", "hla", "pc3_tr"])
def test_ordered_oracle_rows_do_not_depend_on_m(variant):
    """A row's bits depend on that row of ``a`` and on ``w`` only, whatever
    M and the other rows: the row-independence the kernel keeps on both of
    its paths (a decode step's tokens do not depend on the batch)."""
    _, (ta, tw) = _bf16_pair(*_data(12, 3 * dm.KC + 5, 30, seed=8))
    full = dm.daism_matmul_ordered(ta, tw, Variant(variant))
    for lo, hi in ((0, 1), (3, 7), (11, 12), (0, 12)):
        part = dm.daism_matmul_ordered(ta[lo:hi], tw, Variant(variant))
        assert torch.equal(part.view(torch.int32),
                           full[lo:hi].view(torch.int32))


@pytest.mark.parametrize("k", [1, 17, dm.KC])
@pytest.mark.parametrize("variant", ["fla", "pc2", "pc3_tr"])
def test_ordered_oracle_single_chunk_is_one_ascending_sum(k, variant):
    """With K <= KC the order is one ascending f32 sum from 0, bit for bit
    (products from core.floatmul, not from the oracle's own primitives)."""
    from repro_torch.core.floatmul import approx_mul_to_f32

    _, (ta, tw) = _bf16_pair(*_data(6, k, 9, seed=9))
    prods = approx_mul_to_f32(ta[:, :, None], tw[None, :, :], Variant(variant))
    want = torch.zeros((6, 9))
    for i in range(k):
        want = want + prods[:, i]
    got = dm.daism_matmul_ordered(ta, tw, Variant(variant))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_ordered_oracle_chunks_are_summed_in_order():
    """Past one chunk the total is 0 + part_0 + part_1 + ..., each part an
    ascending sum of its KC products: bit for bit, on K = 2 KC + 3."""
    from repro_torch.core.floatmul import approx_mul_to_f32

    k = 2 * dm.KC + 3
    _, (ta, tw) = _bf16_pair(*_data(3, k, 7, seed=10))
    prods = approx_mul_to_f32(ta[:, :, None], tw[None, :, :], Variant.PC3_TR)
    total = torch.zeros((3, 7))
    for c0 in range(0, k, dm.KC):
        part = torch.zeros((3, 7))
        for i in range(c0, min(c0 + dm.KC, k)):
            part = part + prods[:, i]
        total = total + part
    got = dm.daism_matmul_ordered(ta, tw, Variant.PC3_TR)
    assert torch.equal(got.view(torch.int32), total.view(torch.int32))


def test_ordered_oracle_refuses_exact():
    a = torch.zeros((2, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="approximate variants"):
        dm.daism_matmul_ordered(a, a.t().contiguous(), Variant.EXACT)


# ---------------------------------------------------------------------------
# _plan: the one rule that picks the kernel's path (a speed choice only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,variant,plan", [
    ((1, 2048, 2048), "pc3_tr", (1, 1)),      # one active request
    ((4, 2048, 256), "pc3_tr", (1, 1)),       # k/v at decode: a row a block
    ((4, 2048, 2048), "pc3_tr", (4, 1)),      # q/o at decode
    ((4, 2048, 5632), "pc3_tr", (4, 4)),      # wi/wg at decode
    ((4, 2048, 32000), "fla", (4, 4)),        # lm_head at decode
    ((128, 2048, 256), "hla", (16, 1)),       # k/v of a prefill chunk
    ((128, 2048, 5632), "pc3_tr", (16, 4)),   # small tile grid at M = 128
    ((128, 2048, 32000), "pc3_tr", None),     # the lm_head's grid fills it
    ((2048, 2048, 5632), "pc2", None),        # prefill
    # EXACT: (path, tile rows, K slices)
    ((4, 2048, 5632), "exact", ("splitk", 64, 3)),       # wi/wg at decode
    ((1, 2048, 2048), "exact", ("splitk", 64, 8)),       # one request, q/o
    ((1, 2048, 256), "exact", ("splitk", 64, 32)),       # k/v: 32 stages
    ((4, 2048, 32000), "exact", ("tile", 64, 1)),        # lm_head at decode
    ((128, 2048, 5632), "exact", ("tile", 64, 1)),       # the prefill chunk
    ((128, 5632, 2048), "exact", ("splitk", 64, 4)),
    ((128, 2048, 32000), "exact", ("tile", 128, 1)),
    ((2048, 2048, 5632), "exact", ("tile", 128, 1)),     # prefill
    ((2048, 2048, 256), "exact", ("splitk", 64, 2)),     # prefill k/v
    ((512, 32000, 2048), "exact", ("splitk", 128, 4)),   # train lm_head da
    ((5, 70, 33), "exact", ("edge", 64, 2)),             # K, N not 8-aligned
    ((130, 300, 130), "exact", ("edge", 64, 5)),
])
def test_plan_picks_the_measured_path(shape, variant, plan):
    """The shapes of TinyLlama's sites take the plans PERF.md measured."""
    assert dm._plan(*shape, Variant(variant)) == plan


def test_plan_forces_a_path_and_refuses_others():
    assert dm._plan(2048, 2048, 5632, Variant.PC3_TR, "splitk") == (16, 4)
    assert dm._plan(4, 2048, 5632, Variant.PC3_TR, "tile") is None
    with pytest.raises(ValueError, match="path must be"):
        dm._plan(4, 64, 64, Variant.PC3_TR, "fast")
    with pytest.raises(ValueError, match="path must be"):
        dm._plan(4, 64, 64, Variant.PC3_TR, "edge")


@pytest.mark.parametrize("shape", [(4, 2048, 5632), (2048, 2048, 2048),
                                   (130, 296, 136), (1, 8, 8)])
def test_exact_plan_forces_each_path(shape):
    """Forcing keeps the shape's tile rows: ``tile`` one slice, ``splitk``
    at least two where K has two stages, ``edge`` the default's slices;
    every slice count leaves no slice empty."""
    m, k, n = shape
    default = dm._plan(m, k, n, Variant.EXACT)
    stages = -(-k // dm.EXACT_BK)
    for path in dm.EXACT_PATHS:
        got, rows, slices = dm._plan(m, k, n, Variant.EXACT, path)
        assert (got, rows) == (path, default[1])
        assert 1 <= slices <= stages
        assert -(-stages // slices) * (slices - 1) < stages
    assert dm._plan(m, k, n, Variant.EXACT, "tile")[2] == 1
    assert dm._plan(m, k, n, Variant.EXACT, "splitk")[2] >= min(2, stages)
    assert dm._plan(m, k, n, Variant.EXACT, "edge")[2] == default[2]


def test_exact_plan_takes_the_edge_path_where_tma_cannot():
    """TMA needs K and N multiples of 8 and 16-byte-aligned operands: other
    calls take the edge path by default and refuse a forced TMA path."""
    assert dm._plan(4, 2048, 5632, Variant.EXACT, aligned=False)[0] == "edge"
    for shape in ((5, 70, 33), (4, 2048, 5630), (4, 2044, 5632)):
        assert dm._plan(*shape, Variant.EXACT)[0] == "edge"
        for path in ("tile", "splitk"):
            with pytest.raises(ValueError, match="TMA paths need"):
                dm._plan(*shape, Variant.EXACT, path)
    with pytest.raises(ValueError, match="EXACT's path must be"):
        dm._plan(4, 64, 64, Variant.EXACT, "fast")


@pytest.mark.parametrize("shape", SHAPES)
def test_exact_pallas_spelling_matches_interpreted_pallas_kernel(shape):
    """The port's EXACT through ``daism_matmul_pallas`` (on CPU tensors, the
    kernel's plain version) against the JAX package's Pallas EXACT branch,
    interpreted: exact bf16 products summed in f32 in two orders,
    tests/test_kernels.py:41's bounds."""
    (ja, jw), (ta, tw) = _bf16_pair(*_data(*shape, seed=11))
    ref = jpallas(ja, jw, JConfig(variant=JVariant.EXACT,
                                  backend=JBackend.PALLAS, interpret=True))
    got = daism_matmul_pallas(ta, tw, DaismConfig(variant=Variant.EXACT,
                                                  backend=Backend.PALLAS))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
