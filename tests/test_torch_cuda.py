"""The CUDA kernel on the card against its plain version (card only).

Run on a machine with a card: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Without one these tests skip. The file imports
neither jax nor the JAX package, so it runs where only torch is installed.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.kernels import daism_matmul as dm  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 300, 130), (1, 1, 1), (64, 33, 65),
                                   (130, 300, 130)])
@pytest.mark.parametrize("variant", [v.value for v in Variant])
def test_kernel_matches_plain_version(cuda, variant, shape):
    """Ragged shapes: f32 summation order differs (bound as in
    chip_smoke.py); the products themselves are identical."""
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda).to(torch.bfloat16)
    before = dm.launches
    got = dm.daism_matmul_kernel(a, w, Variant(variant))
    ref = dm.daism_matmul_plain(a, w, Variant(variant))
    torch.cuda.synchronize()
    assert dm.launches == before + 1
    bound = 4e-4 * (a.double().abs() @ w.double().abs()) + 1e-6
    assert bool(((got.double() - ref.double()).abs() <= bound).all())


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16-only"):
        dm.daism_matmul_kernel(a.float(), a.float().t().contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        dm.daism_matmul_kernel(a, a.t())
    with pytest.raises(ValueError, match="inner dims"):
        dm.daism_matmul_kernel(a, a)
