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
    big = torch.zeros((1, 128, 264), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_kernel(big, big, big)


APPROX = [v.value for v in Variant if v is not Variant.EXACT]


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 512, 384), (1, 300, 130), (16, 200, 1030),
                                   (3, 64, 5), (80, 700, 96)])
@pytest.mark.parametrize("variant", APPROX)
def test_both_paths_bit_identical_to_ordered_oracle(cuda, variant, shape):
    """The tile path, the split-K path and the default choice each equal
    daism_matmul_ordered bit for bit (decode shapes, a single-chunk K, and
    M = 80, past the split-K threshold)."""
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda).to(torch.bfloat16)
    ref = dm.daism_matmul_ordered(a, w, Variant(variant))
    before = dm.launches
    for path in ("tile", "splitk", None):
        got = dm._launch(a, w, Variant(variant), path)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref)), path
    assert dm.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fla", "hla", "pc3_tr"])
def test_kernel_rows_do_not_depend_on_m(cuda, variant):
    """Rows 0-3 of an M = 128 launch (tile path) equal an M = 4 launch
    (split-K path) and an M = 1 launch on the same rows, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((128, 700), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((700, 260), generator=g, device=cuda).to(torch.bfloat16)
    big = dm.daism_matmul_kernel(a, w, Variant(variant))
    small = dm.daism_matmul_kernel(a[:4].contiguous(), w, Variant(variant))
    one = dm.daism_matmul_kernel(a[2:3].contiguous(), w, Variant(variant))
    torch.cuda.synchronize()
    assert torch.equal(_bits(big[:4]), _bits(small))
    assert torch.equal(_bits(big[2:3]), _bits(one))


@pytest.mark.cuda
def test_split_k_counts_its_second_pass(cuda):
    """One count per GEMM call whatever the path; the chunk sum counts
    apart, and only when K spans more than one chunk."""
    a = torch.ones((4, 3 * dm.KC), dtype=torch.bfloat16, device=cuda)
    w = torch.ones((3 * dm.KC, 8), dtype=torch.bfloat16, device=cuda)
    n0, s0 = dm.launches, dm.sum_launches
    dm._launch(a, w, Variant.PC3_TR, "splitk")
    dm._launch(a[:, :dm.KC].contiguous(), w[:dm.KC].contiguous(),
               Variant.PC3_TR, "splitk")
    dm._launch(a, w, Variant.PC3_TR, "tile")
    assert (dm.launches - n0, dm.sum_launches - s0) == (3, 1)
    with pytest.raises(ValueError, match="path must be"):
        dm._launch(a, w, Variant.PC3_TR, "edge")


def _exact_held(got, ref, a, w):
    """chip_smoke.py's gemm_held bound: another f32 summation order of the
    same exact products."""
    k = a.shape[1]
    rtol = 4e-4 * max(1.0, k / 5632)
    bound = rtol * (a.double().abs() @ w.double().abs()) + 1e-6
    return bool(torch.isfinite(got).all()) and bool(
        ((got.double() - ref.double()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2048, 1024), (130, 296, 136),
                                   (200, 1000, 520), (37, 300, 130),
                                   (5, 70, 33), (1, 1, 1)])
def test_exact_paths_match_plain_version(cuda, shape):
    """EXACT forced onto each of its paths: the TMA paths (tile, split-K) at
    K and N multiples of 8, ragged past the tiles or not, the edge path
    everywhere; each within the gemm_held bound of the plain version, one
    launch a call whatever the path. A TMA path refuses the other shapes."""
    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=g, device=cuda).to(torch.bfloat16)
    ref = dm.daism_matmul_plain(a, w, Variant.EXACT)
    tma = dm._plan(m, k, n, Variant.EXACT)[0] != "edge"
    for path in dm.EXACT_PATHS + (None,):
        if path in ("tile", "splitk") and not tma:
            with pytest.raises(ValueError, match="TMA paths need"):
                dm._launch(a, w, Variant.EXACT, path)
            continue
        n0, s0 = dm.launches, dm.sum_launches
        got = dm._launch(a, w, Variant.EXACT, path)
        torch.cuda.synchronize()
        slices = dm._plan(m, k, n, Variant.EXACT, path)[2]
        assert (dm.launches - n0, dm.sum_launches - s0) == (1, slices > 1)
        assert _exact_held(got, ref, a, w), path


@pytest.mark.cuda
def test_exact_keeps_subnormal_inputs_and_overflows_to_inf(cuda):
    """K = 1 products of bf16 subnormals (0x7F, 0x40, 0x01) with values of
    exponent 254 are normal; products past f32's range are inf. Every path
    (the TMA paths on the same products zero-padded to K = 8) gives the
    plain version's products within 2**-126."""
    bits = torch.tensor([0x7F, 0x40, 0x01, 0x7F7F, 0x7F00, 0x3F80, 0x0080,
                         0x8000 | 0x7F, 0x8000 | 0x7F7F], device=cuda)
    x = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(
        torch.int16).view(torch.bfloat16)
    a1, w1 = x[:, None].contiguous(), x[None, :].contiguous()
    ref = dm.daism_matmul_plain(a1, w1, Variant.EXACT)
    assert bool(torch.isinf(ref).any()) and bool((ref.abs() > 1).any())
    a8 = torch.zeros((x.numel(), 8), dtype=torch.bfloat16, device=cuda)
    w8 = torch.zeros((8, 16), dtype=torch.bfloat16, device=cuda)
    a8[:, :1], w8[:1, :x.numel()] = a1, w1
    for a, w, path in ((a1, w1, "edge"), (a8, w8, "edge"), (a8, w8, "tile"),
                       (a8, w8, "splitk")):
        got = dm._launch(a, w, Variant.EXACT, path)[:, :x.numel()]
        torch.cuda.synchronize()
        assert bool(((got == ref) | ((got - ref).abs() <= 2.0**-126)).all()), \
            path


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 20, 40, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(8, 2), (4, 4)])
def test_tensor_core_exact_flash_matches_plain_version(cuda, d, causal, heads):
    """bf16 exact flash (the tensor-core kernel) within the JAX suite's
    exact bound, 2e-3 + 2e-2 |plain|, and within one bf16 rounding of the
    plain version, 2**-7 |plain| + 2**-16 max|v| (chip_smoke.py's
    FLASH_EXACT_ULP): D padded to a multiple of 16 (D = 20 also takes the
    gather load), GQA and MHA, causal at a ragged S = 300, non-causal at
    ragged Sq = 100, Skv = 200."""
    h, kh = heads
    sq, skv = (300, 300) if causal else (100, 200)
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((2, sq, h, d), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((2, skv, kh, d), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((2, skv, kh, d), generator=g, device=cuda).to(torch.bfloat16)
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    err = (got.float() - ref.float()).abs()
    assert bool((err <= 2e-3 + 2e-2 * ref.float().abs()).all())
    one_rounding = 2.0**-7 * ref.float().abs() + 2.0**-16 * v.float().abs().max()
    assert bool((err <= one_rounding).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 28, 1, 6, 5), (8, 14, 6, 16, 5),
                                   (2, 32, 3, 64, 3), (2, 32, 64, 64, 3)])
def test_conv2d_im2col_on_the_kernel_matches_plain_version(cuda, shape):
    """(B, side, cin, cout, k): LeNet-5's and VGG-16's first two convs,
    SAME, bf16, PC3_TR. The card's im2col GEMM launches the kernel; the
    same call on CPU tensors takes its plain version. Bound as in
    chip_smoke.py: 4e-4 * (|patches| @ |kernel|) + 1e-6, the f32
    summation-order bound for K <= 5632."""
    from repro_torch.core.config import Backend, DaismConfig
    from repro_torch.core.gemm import conv2d_im2col

    b, side, cin, cout, k = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((b, side, side, cin), generator=g,
                    device=cuda).to(torch.bfloat16)
    w = torch.randn((k, k, cin, cout), generator=g,
                    device=cuda).to(torch.bfloat16)
    cfg = DaismConfig(variant=Variant.PC3_TR, backend=Backend.PALLAS)
    before = dm.launches
    got = conv2d_im2col(x, w, cfg)
    torch.cuda.synchronize()
    assert dm.launches == before + 1
    ref = conv2d_im2col(x.cpu(), w.cpu(), cfg)
    mag = conv2d_im2col(x.cpu().double().abs(), w.cpu().double().abs(),
                        DaismConfig(variant=Variant.EXACT))
    assert got.shape == ref.shape == (b, side, side, cout)
    err = (got.cpu().double() - ref.double()).abs()
    assert bool((err <= 4e-4 * mag + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "VALID")])
def test_f32_exact_conv_is_full_f32_under_default_tf32_flag(cuda, stride,
                                                            padding):
    """An f32 exact conv on the card is full f32, not TF32, whatever the
    caller's ``torch.backends.cudnn.allow_tf32`` (PyTorch's default is
    True, and it is set so here): within rtol 1e-5 (and 1e-5 of the
    largest output) of the same conv on the CPU. A TF32 conv misses it by
    ~30x (2.9e-4 of the largest output at this shape on the H100). The
    caller's flag is left as it was."""
    from repro_torch.core.config import Backend, DaismConfig
    from repro_torch.core.gemm import conv2d_im2col

    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 32, 32, 64), generator=g)
    w = torch.randn((3, 3, 64, 128), generator=g) * 0.05
    exact = DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = conv2d_im2col(x.to(cuda), w.to(cuda), exact, stride=stride,
                            padding=padding)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    ref = conv2d_im2col(x, w, exact, stride=stride, padding=padding)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5,
                               atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
def test_checkpoint_of_cuda_tensors_roundtrips_bit_for_bit(cuda, tmp_path):
    """bf16, f32 and an int32 step on the card: saved, restored onto the
    card (the device of ``like``), in fresh memory, bit for bit."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim import init_state

    g = torch.Generator(device=cuda).manual_seed(4)
    params = {"w": torch.randn((64, 33), generator=g,
                               device=cuda).to(torch.bfloat16),
              "s": torch.randn((33,), generator=g, device=cuda)}
    tree = {"params": params, "opt": init_state(params)}
    tree["opt"].m["w"].normal_(generator=g)
    ckpt.save(str(tmp_path), 3, tree)
    out = ckpt.restore(str(tmp_path), 3, tree)
    src, dst = ckpt._flatten(tree), ckpt._flatten(out)
    assert set(src) == set(dst)
    for key, a in src.items():
        b = dst[key]
        assert b.device == a.device and b.dtype == a.dtype, key
        assert b.data_ptr() != a.data_ptr(), key
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), key


@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 192, 200, 256])
@pytest.mark.parametrize("variant", [None, "pc3_tr", "fla", "hla", "pc2",
                                     "pc3", "pc2_tr"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_at_large_head_dims_matches_plain_version(cuda, d, variant,
                                                        causal):
    """Head dims past 128 (Nemotron-4's 192, Gemma's 256, and two that pad
    to them): exact bf16 on the tensor-core kernel's 64-key tiles within
    the JAX suite's bound and one bf16 rounding, the six approximate
    variants within 1e-3 + 2**-6 |plain| (the bounds of
    test_flash_kernel_matches_plain_version); MQA causal at a ragged S =
    200, GQA non-causal at Sq = 100, Skv = 300."""
    b, sq, skv, h, kh = (1, 200, 200, 4, 1) if causal else (2, 100, 300, 4, 2)
    g = torch.Generator(device=cuda).manual_seed(6)
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
    assert bool((err <= atol + rtol * ref.float().abs()).all())
    if var is None:
        one_rounding = (2.0**-7 * ref.float().abs()
                        + 2.0**-16 * v.float().abs().max())
        assert bool((err <= one_rounding).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256])
def test_f32_flash_at_large_head_dims_matches_plain_version(cuda, d):
    """f32 exact (the integer-path kernel's fmaf mode) at D = 192 and 256
    within the JAX suite's exact bound."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((1, 150, 2, d), generator=g, device=cuda)
               for _ in range(3))
    for causal in (True, False):
        got = fa.flash_attention_bhsd(q, k, v, causal=causal)
        ref = fa.flash_attention_bhsd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        assert bool((err <= 2e-3 + 2e-2 * ref.abs()).all())


# (E, C, K, N): Qwen3-MoE-like and DBRX-like narrow cases, a ragged one, a
# single chunk and one row
EXPERT_SHAPES = [(8, 4, 512, 384), (4, 128, 256, 320), (3, 16, 700, 96),
                 (5, 1, 64, 130), (2, 37, 300, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EXPERT_SHAPES)
@pytest.mark.parametrize("variant", ["fla", "hla", "pc3_tr"])
@pytest.mark.parametrize("shared_x", [False, True])
def test_expert_kernel_bit_identical_to_per_expert_launches(cuda, shape,
                                                            variant,
                                                            shared_x):
    """One launch for E experts equals E 2-D launches bit for bit, on the
    tile path, the split-K path and the default choice; ``shared_x``
    passes one (C, K) operand to every expert as an ``expand``ed view
    (expert stride 0), as the dense MoE does. The first expert also equals
    daism_matmul_ordered."""
    e, c, k, n = shape
    var = Variant(variant)
    g = torch.Generator(device=cuda).manual_seed(8)
    if shared_x:
        x = torch.randn((c, k), generator=g, device=cuda).to(
            torch.bfloat16)[None].expand(e, c, k)
    else:
        x = torch.randn((e, c, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((e, k, n), generator=g, device=cuda).to(torch.bfloat16)
    ref = torch.stack([dm.daism_matmul_kernel(x[i].contiguous(), w[i], var)
                       for i in range(e)])
    before = dm.launches
    for path in ("tile", "splitk", None):
        got = dm._launch_experts(x, w, var, path)
        torch.cuda.synchronize()
        assert got.shape == (e, c, n)
        assert torch.equal(_bits(got), _bits(ref)), path
    assert dm.launches == before + 3
    ordered = dm.daism_matmul_ordered(x[0].contiguous(), w[0], var)
    assert torch.equal(_bits(ref[0]), _bits(ordered))


@pytest.mark.cuda
def test_expert_kernel_matches_plain_and_refuses_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((3, 8, 200), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((3, 200, 72), generator=g, device=cuda).to(torch.bfloat16)
    got = dm.daism_matmul_experts_kernel(x, w, Variant.PC3_TR)
    ref = dm.daism_matmul_experts_plain(x, w, Variant.PC3_TR)
    torch.cuda.synchronize()
    bound = 4e-4 * (x.double().abs() @ w.double().abs()) + 1e-6
    assert bool(((got.double() - ref.double()).abs() <= bound).all())
    with pytest.raises(ValueError, match="approximate"):
        dm.daism_matmul_experts_kernel(x, w, Variant.EXACT)
    with pytest.raises(ValueError, match="row-major"):
        dm.daism_matmul_experts_kernel(x.transpose(1, 2).contiguous()
                                       .transpose(1, 2), w)


@pytest.mark.cuda
def test_tied_lm_head_bits_unchanged_by_the_hoisted_transpose(cuda):
    """A tied-embedding model's logits through the kept ``embedding.T``
    equal, bit for bit, those through a fresh transpose at every call, on
    the kernel (``*=pc3_tr:pallas``) and exact."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    for spec in ("*=pc3_tr:pallas", "*=exact"):
        cfg = get_config("gemma_2b").smoke(n_layers=2, vocab=512).with_policy(
            spec)
        model = build_model(cfg, device=cuda)
        params = model.init(0)
        toks = torch.randint(0, 512, (2, 16), device=cuda,
                             generator=torch.Generator(device=cuda).manual_seed(0))
        with torch.no_grad():
            first, _ = model.forward(params, {"tokens": toks})
            kept, _ = model.forward(params, {"tokens": toks})
            del params["embedding"]._repro_lm_head
            fresh, _ = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert torch.equal(first, kept) and torch.equal(first, fresh), spec


@pytest.mark.cuda
@pytest.mark.parametrize("arch,spec,flash", [
    ("whisper_large_v3", "*=pc3_tr:pallas", 0),
    ("whisper_large_v3", "*/kernel=pc3_tr:flash,*=pc3_tr:pallas", 6),
    ("xlstm_1_3b", "*=pc3_tr:pallas", 0),
    ("zamba2_1_2b", "*/kernel=pc3_tr:flash,*=pc3_tr:pallas", 0)])
def test_rest_of_zoo_on_the_kernels_matches_the_cpu(cuda, arch, spec, flash):
    """Whisper, xLSTM and Zamba (bf16 smoke configs) on the card, where
    every approximate GEMM site launches the kernel once and Whisper's
    three attention sites a layer pair launch flash (Zamba's windowed
    attention never does), against the same weights and inputs on the CPU
    (the plain versions): within 0.2 of max |logit| (chip_smoke.py's
    bound for approximate GEMMs)."""
    from repro_torch.analyze import trace_site_graph
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.module import flatten, unflatten
    from repro_torch.policy import OpKind

    cfg = get_config(arch).smoke(vocab=512).with_policy(spec)
    card, cpu = (build_artifacts(cfg, device=d) for d in (cuda, "cpu"))
    params = card.init_params(0)
    params_cpu = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 512, (2, 12), generator=g)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.enc_frames, cfg.d_model),
                                      generator=g)
    sites = sum(s.repeat for s in trace_site_graph(cfg).sites
                if s.kind is not OpKind.ATTN_QK)
    dm.launches = fa.launches = 0
    got = card.prefill_step(params, batch)
    torch.cuda.synchronize()
    assert (dm.launches, fa.launches) == (sites, flash)
    ref = cpu.prefill_step(params_cpu, batch)
    got = got.float().cpu()
    ref = ref.float()
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max() <= 0.2 * ref.abs().max()
