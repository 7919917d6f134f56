"""The CUDA kernels on the card against their plain versions (card only).

Run on a machine with a card: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Without one these tests skip. The file imports
neither jax nor the JAX package, so it runs where only torch is installed.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.kernels import daism_matmul as dm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 256, 256, 8, 2, 64),
                                   (2, 100, 72, 4, 2, 64),
                                   (1, 130, 130, 2, 1, 16),
                                   (1, 128, 128, 2, 2, 128)])
@pytest.mark.parametrize("variant", [None, "pc3_tr", "fla", "hla"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain_version(cuda, variant, shape, causal):
    """(B, Sq, Skv, H, KH, D) in bf16; bounds as in chip_smoke.py: exact
    2e-3 + 2e-2 |plain|, approximate 1e-3 + 2**-6 |plain| (the same KV
    tiles in the same order; only the f32 summation order differs, which
    leaves the outputs a bf16 rounding apart, or rounds a p to the
    neighbouring bf16 and moves its approximate PV product)."""
    b, sq, skv, h, kh, d = shape
    if causal and sq != skv:
        pytest.skip("the model sends only Sq == Skv causal calls")
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, skv, kh, d), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, skv, kh, d), generator=g, device=cuda).to(torch.bfloat16)
    var = variant and Variant(variant)
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal, variant=var)
    ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal, variant=var)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    err = (got.float() - ref.float()).abs()
    rtol, atol = (2e-2, 2e-3) if var is None else (2.0**-6, 1e-3)
    bound = atol + rtol * ref.float().abs()
    assert bool((err <= bound).all())


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 128, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16-only"):
        fa.flash_attention_kernel(q.float(), q.float(), q.float(),
                                  variant=Variant.PC3_TR)
    with pytest.raises(ValueError, match="tiles of 128"):
        fa.flash_attention(q, q, q, block_k=64)
    big = torch.zeros((1, 128, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_kernel(big, big, big)
