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
