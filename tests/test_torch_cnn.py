"""Port parity: the paper's CNNs (LeNet-5, VGG-8, VGG-16) and the im2col
convolution under them, against the JAX package.

Tolerances:
* ``conv2d_im2col``: exact f32 within 1e-5 (the library convolution of
  each framework, summed in another order); approximate variants within
  tests/test_kernels.py:41's rtol 1e-5 / atol 1e-4: the patches and the
  products are the same, only the f32 summation order may differ.
* CNN logits, exact: rtol = atol = 1e-4 (f32 rounding only).
* CNN logits, ``*=pc3_tr``: the DAISM products are discontinuous at carry
  boundaries, so a 1-ulp difference upstream (the exact library
  convolution of the first layer, tanh) can move a product by up to
  ~2**-3 of itself, and the nets amplify it: nudging the port's LeNet-5
  tanh outputs by one ulp moves its ``cnn/c2=pc3_tr`` logits by 3.2% of
  their range, and nudging the JAX VGG-8's input by one ulp moves its
  ``*=pc3_tr`` logits by 11% and flips a label. Each bound on max|dlogits|
  / max|ref| (``CNN_REL``) is about 1.5x the port-vs-JAX gap measured on
  these inputs (in the comments); labels must agree on every row whose
  top-2 gap exceeds the bound.
* one STE AdamW step of LeNet-5: tests/test_torch_train.py's exact bounds
  for ``*=exact``; for ``*=pc3_tr`` bounds at ~1.5x the measured gaps
  (``STE_TOL``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.optim as jopt  # noqa: E402
import repro.policy as jpolicy  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import Backend as JBackend  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.core.gemm import conv2d_im2col as jconv  # noqa: E402
from repro.models.cnn import CNNModel as JCNN  # noqa: E402
from repro.models.registry import classifier_loss as jloss  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
import repro_torch.policy as tpolicy  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import ALL_VARIANTS, Backend, DaismConfig  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.core.gemm import conv2d_im2col  # noqa: E402
from repro_torch.models.cnn import CNNModel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.module import flatten, unflatten  # noqa: E402
from repro_torch.models.registry import build_model, classifier_loss  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (k, stride, padding, image side): both kernel sizes, both strides, both
# paddings, an odd side so SAME pads unevenly at stride 2
CONV_CASES = [(3, 1, "SAME", 8), (5, 1, "SAME", 9), (3, 2, "SAME", 9),
              (5, 2, "SAME", 8), (3, 1, "VALID", 8), (5, 2, "VALID", 9)]
IMAGE = {"lenet5": (4, 28, 28, 1), "vgg8": (2, 32, 32, 3),
         "vgg16": (1, 32, 32, 3)}
# (net, spec) -> bound on max|dlogits| / max|ref|; measured gap in the
# comment
CNN_REL = {
    ("lenet5", "*=pc3_tr"): 0.095,     # 0.0636
    ("vgg8", "*=pc3_tr"): 0.065,       # 0.0416
}


def _conv_operands(k, side, cin=3, cout=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, side, side, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) / k).astype(np.float32)
    return x, w


def _t(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def test_exact_conv_matches_jax():
    for k, stride, pad, side in CONV_CASES:
        x, w = _conv_operands(k, side)
        ref = np.asarray(jconv(jnp.asarray(x), jnp.asarray(w),
                               JConfig(variant=JVariant.EXACT),
                               stride=stride, padding=pad))
        got = conv2d_im2col(_t(x), _t(w), DaismConfig(variant=Variant.EXACT),
                            stride=stride, padding=pad)
        assert tuple(got.shape) == ref.shape, (k, stride, pad)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [v.value for v in ALL_VARIANTS])
def test_approx_conv_matches_jax(variant, dtype):
    """Every approximate variant (jnp backend) at every case of
    CONV_CASES: the (cin, kh, kw) patch order and the SAME/VALID padding
    at both strides."""
    for k, stride, pad, side in CONV_CASES:
        x, w = _conv_operands(k, side, seed=k + stride)
        jx = jnp.asarray(x, dtype)
        jw = jnp.asarray(w, dtype)
        ref = np.asarray(jconv(jx, jw, JConfig(variant=JVariant(variant)),
                               stride=stride, padding=pad), np.float32)
        got = conv2d_im2col(_t(jx), _t(jw),
                            DaismConfig(variant=Variant(variant)),
                            stride=stride, padding=pad)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == ref.shape, (k, stride, pad)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_pallas_spelling_conv_equals_jnp_backend():
    """bf16 ``pallas`` (the kernel's plain version on CPU tensors) computes
    the jnp backend's function: the same products, summed in another f32
    order (rtol 1e-5 / atol 1e-4)."""
    x, w = _conv_operands(5, 9, cin=6, cout=16)
    x, w = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    got = conv2d_im2col(x, w, DaismConfig(variant=Variant.PC3_TR,
                                          backend=Backend.PALLAS))
    ref = conv2d_im2col(x, w, DaismConfig(variant=Variant.PC3_TR))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)


def _sites(events):
    return {(e.path, e.kind.value): (e.dims, e.macs, e.dtype) for e in events}


@pytest.mark.parametrize("net,spec", [
    ("lenet5", "cnn/c1=exact,@lm_head=exact,*=pc3_tr"),
    ("vgg8", "cnn/c0=pc3_tr,cnn/f1=pc3_tr,*=exact")])
def test_policy_conv2d_resolution_matches_jax(net, spec):
    """Every site a forward resolves (``OpKind.CONV`` for the convs,
    ``LM_HEAD`` for ``out``): the resolution log's config, dtype and
    multiply count, and the observed GEMM dims, equal JAX's."""
    jcfg, tcfg = jget(net).with_policy(spec), tget(net).with_policy(spec)
    jm = JCNN(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    images = np.zeros(IMAGE[net], np.float32)
    jev, tev = [], []
    jpolicy.clear_log(jcfg.approx_policy)
    tpolicy.clear_log(tcfg.approx_policy)
    with jpolicy.observe_sites(jev.append):
        jm.forward(jp, {"images": jnp.asarray(images)})
    with tpolicy.observe_sites(tev.append):
        CNNModel(tcfg, device="cpu").forward(tp, {"images": _t(images)})
    assert _sites(tev) == _sites(jev)
    kinds = {k for _, k in _sites(tev)}
    assert kinds == {"conv", "dense", "lm_head"}
    jlog = jpolicy.resolution_log(jcfg.approx_policy)
    tlog = tpolicy.resolution_log(tcfg.approx_policy)
    assert {(p, k.value) for p, k in tlog} == {(p, k.value) for p, k in jlog}
    for (path, kind), (cfg, dt, macs) in jlog.items():
        tcfg_, tdt, tmacs = tlog[(path, tpolicy.OpKind(kind.value))]
        assert (tcfg_.variant.value, tdt, tmacs) == (cfg.variant.value, dt,
                                                     macs), path


@pytest.mark.parametrize("net,n_leaves", [("lenet5", 10), ("vgg8", 14),
                                          ("vgg16", 30)])
def test_param_specs_match_jax_init(net, n_leaves):
    jp, _ = JCNN(jget(net)).init(jax.random.PRNGKey(0), abstract=True)
    specs = CNNModel(tget(net), device="cpu").param_specs()
    assert len(specs) == n_leaves
    assert {k: v[0] for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert {v[1] for v in specs.values()} == {"float32"}
    own = CNNModel(tget(net), device="cpu").init(0)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v[0] for k, v in specs.items()}


def test_init_draws_lecun_and_he():
    """LeNet-5 is lecun everywhere; the VGG convs are He (std sqrt(2 /
    (k*k*cin))); biases are zero."""
    p = CNNModel(tget("lenet5"), device="cpu").init(0)
    assert abs(float(p["c2"].std()) - 1 / np.sqrt(6)) < 0.02  # fan_in = cin
    assert float(p["f1"].std()) == pytest.approx(1 / np.sqrt(784), rel=0.05)
    p = CNNModel(tget("vgg8"), device="cpu").init(0)
    assert float(p["c1"].std()) == pytest.approx(np.sqrt(2 / 576), rel=0.05)
    assert not any(float(v.abs().max()) for k, v in p.items()
                   if k.endswith("_b"))


def _check(ref, got, net, spec):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        return
    bound = CNN_REL[(net, spec)] * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > bound
    assert clear.sum() >= 1
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])


@pytest.mark.parametrize("net", ["lenet5", "vgg8"])
@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
def test_cnn_logits_match_jax(net, spec):
    jm = JCNN(jget(net))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tcfg = tget(net).with_policy(spec)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    images = np.random.default_rng(0).normal(size=IMAGE[net]).astype(
        np.float32)
    ref, _ = JCNN(jget(net).with_policy(spec)).forward(
        jp, {"images": jnp.asarray(images)})
    got, aux = CNNModel(tcfg, device="cpu").forward(tp,
                                                    {"images": _t(images)})
    assert float(aux) == 0.0
    _check(ref, got, net, spec)


def test_vgg16_full_width_exact_matches_jax():
    """VGG-16 at its published widths (CIFAR-10 shape, B = 1), exact."""
    jm = JCNN(jget("vgg16"))
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tget("vgg16"),
                         device="cpu")
    images = np.random.default_rng(1).normal(size=IMAGE["vgg16"]).astype(
        np.float32)
    ref, _ = jm.forward(jp, {"images": jnp.asarray(images)})
    got, _ = build_model(tget("vgg16"), device="cpu").forward(
        tp, {"images": _t(images)})
    _check(ref, got, "vgg16", "*=exact")


# (loss rel, grad_norm rel, update rel) of one LeNet-5 step; measured in
# the comments. exact: tests/test_torch_train.py's bounds. pc3_tr: the
# forward's gap (above) moves the loss, and AdamW's first update is about
# lr * sign(g) per element, so an element whose gradient is near zero can
# move either way: the update is compared by its L2 error relative to the
# step; ~1.5x the measured gaps.
STE_TOL = {"*=exact": (1e-5, 1e-5, 1e-4),          # 0, 0, 8.8e-5
           "*=pc3_tr": (3.5e-3, 1.3e-3, 0.38)}     # 2.35e-3, 8.6e-4, 0.256


@pytest.mark.parametrize("spec", ["*=exact", "*=pc3_tr"])
def test_lenet_ste_adamw_step_matches_jax(spec):
    """One AdamW step (straight-through backward) of LeNet-5 on the same
    weights and batch: loss, grad norm and the update (``STE_TOL``)."""
    tol = STE_TOL[spec]
    jcfg, tcfg = jget("lenet5").with_policy(spec), tget("lenet5").with_policy(
        spec)
    jm, tm = JCNN(jcfg), CNNModel(tcfg, device="cpu")
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    before = {k: v.clone() for k, v in tp.items()}
    rng = np.random.default_rng(2)
    images = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 8).astype(np.int32)
    ocfg_j = jopt.AdamWConfig(lr=1e-3, weight_decay=0.01)
    ocfg_t = topt.AdamWConfig(lr=1e-3, weight_decay=0.01)

    def jloss_fn(p):
        logits, _ = jm.forward(p, {"images": jnp.asarray(images)})
        return jloss(logits, jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss_fn)(jp)
    jp2, _, jmet = jopt.apply_updates(jp, jg, jopt.init_state(jp), ocfg_j)

    leaves = list(flatten(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = tm.forward(tp, {"images": _t(images)})
    tl = classifier_loss(logits, _t(labels))
    grads = torch.autograd.grad(tl, leaves)
    for t in leaves:
        t.requires_grad_(False)
    gtree = unflatten(dict(zip(flatten(tp), grads)))
    tp2, _, tmet = topt.apply_updates(tp, gtree, topt.init_state(tp), ocfg_t)
    for got, ref, rel in ((float(tl.detach()), float(jl), tol[0]),
                          (float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                           tol[1])):
        assert abs(got - ref) <= rel * abs(ref), (got, ref)
    err = np.sqrt(sum(np.sum((tp2[k].numpy() - np.asarray(v)) ** 2)
                      for k, v in jp2.items()))
    moved = np.sqrt(sum(np.sum((np.asarray(v) - before[k].numpy()) ** 2)
                        for k, v in jp2.items()))
    assert moved > 0 and err <= tol[2] * moved, (err, moved)


def test_f32_under_a_pallas_rule_raises_in_both_packages():
    """The kernel is bf16-only: an f32 CNN config with a pallas rule fails
    at construction in both packages, naming the backend."""
    with pytest.raises(ValueError, match="bfloat16-only"):
        jget("lenet5").with_policy(jpolicy.ApproxPolicy.uniform(JConfig(
            variant=JVariant.PC3_TR, backend=JBackend.PALLAS)))
    with pytest.raises(ValueError, match="bfloat16-only"):
        tget("lenet5").with_policy("*=pc3_tr:pallas")
    # and at a site resolved on f32 operands under a bf16 config's policy
    cfg = tget("lenet5")
    pol = tpolicy.parse_policy("*=pc3_tr:pallas")
    with pytest.raises(ValueError, match="bfloat16-only"):
        tpolicy.policy_conv2d(pol, torch.zeros((1, 8, 8, 1)),
                              torch.zeros((3, 3, 1, 2)), name="c1")
    assert cfg.compute_dtype == "float32"


# net -> (batch, bound on max|pallas - jnp| / max|jnp| in bf16): the
# measured gap in the comment (these inputs; for VGG-16 also one
# image_batches(10, 1, shape=(32, 32, 3), noise=0.9, seed=1) image), the
# bound ~1.5x the larger; LeNet-5 measures 0 here, and its bound leaves a
# few bf16 roundings (2**-7 each) of room. chip_smoke.py holds the kernel
# on the card to the same bounds.
BF16_PALLAS_REL = {"lenet5": (8, 2e-2),    # 0.0
                   "vgg16": (1, 0.15)}     # 0.0822 (0.0993 on seed 1)


@pytest.mark.parametrize("net", ["lenet5", "vgg16"])
def test_bf16_pallas_cnn_equals_jnp_backend(net):
    """The CNNs in bf16 as benchmarks/accuracy.py casts them (params and
    compute), at their published widths: the ``pallas`` spelling (the
    kernel's plain version on CPU tensors) against the jnp backend. Both
    compute the same products and add them in another f32 order, so a
    layer's bf16 output can round one ulp apart, which the next layer's
    approximate products amplify as above (VGG-16: 15 layers). Logits
    within ``BF16_PALLAS_REL`` of max|logit|; labels agree on every row
    whose top-2 gap exceeds the deviation."""
    import dataclasses

    batch, rel = BF16_PALLAS_REL[net]
    base = dataclasses.replace(tget(net), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = CNNModel(base, device="cpu").init(0)
    shape = CNNModel(base, device="cpu").default_image_shape()[1:]
    images = _t(np.random.default_rng(3).normal(
        size=(batch,) + shape).astype(np.float32))
    out = {}
    for spec in ("*=pc3_tr:pallas", "*=pc3_tr"):
        out[spec], _ = CNNModel(base.with_policy(spec), device="cpu").forward(
            params, {"images": images})
    ref, got = out["*=pc3_tr"], out["*=pc3_tr:pallas"]
    dev = float((got - ref).abs().max())
    assert dev <= rel * float(ref.abs().max())
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > dev
    assert bool((got.argmax(-1) == ref.argmax(-1))[clear].all())


def test_cnn_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        CNNModel(tget("lenet5"))
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({}, tget("lenet5"))
