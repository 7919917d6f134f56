"""Port parity: the roofline's counters (``repro_torch/roofline``) against
``tests/test_roofline.py`` and the reference's counts of TinyLlama.

Counterparts of ``tests/test_roofline.py``: a loop of 8 (128, 128)
matmuls counts exactly 8 x 2 x 128^3; the gradient counts 2.8-3.3x the
forward; ``full`` remat counts more than 1.1x no remat; a recorded
collective tally gives the hand-computed ring bytes exactly;
``model_flops_estimate`` equals the reference's for every ``ARCH_ID`` x
{train, prefill, decode} (rel 1e-12). ``test_xla_counts_scan_body_once``
(``:20``) and ``test_probe_correction_matches_full_unroll`` (``:84``)
read XLA's ``cost_analysis``: the port has no compiler, so they have no
counterpart; ``test_collective_parser_on_hlo_text``'s (``:64``) holds a
recorded collective tally, the port's source of wire bytes, in place of
HLO text.

Model level, TinyLlama-1.1B at published width on ``meta`` against the
reference's ``jaxpr`` (a 1 x 1 ``Mesh``): the forward at B = 1, S = 2048
and the train step at B = 2, S = 256. The matmul FLOPs (``mm``/``bmm``
against ``dot_general``) are equal exactly under ``*=exact``, in the
forward and in the train step under every remat mode. Under
``*=pc3_tr:pallas`` the kernel calls equal the ``pallas_call``s exactly
in the forward and the train step without remat; with ``full`` remat the
port calls the kernel once more a layer: ``torch.utils.checkpoint`` stops
a layer's recompute only after the layer's last GEMM (``ffn/wo``) has
run, where the reference's dead-code elimination drops it. The totals
are within 1% (forward) and 2% (train step) of the reference's.
"""
import dataclasses
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch.steps import build_artifacts as jbuild  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro.roofline.flops import _conv_flops, _dot_flops, jaxpr_flops  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.steps import build_artifacts  # noqa: E402
from repro_torch.models.transformer import apply_remat  # noqa: E402
from repro_torch.parallel.sharding import (Sharder, base_rules,  # noqa: E402
                                           record_collectives)
from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.roofline.flops import Tally, count, count_flops  # noqa: E402


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _loop_mm(x, w):
    for i in range(w.shape[0]):
        x = x @ w[i]
    return x


def test_loop_of_matmuls_counts_every_trip():
    x, w = _meta(128, 128), _meta(8, 128, 128)
    assert count_flops(_loop_mm, x, w) == 8 * 2 * 128 ** 3


def _grad_flops(f, x, w):
    w = w.requires_grad_()

    def step(x, w):
        return torch.autograd.grad((f(x, w) ** 2).sum(), [w])[0]

    return count_flops(step, x, w)


def test_gradient_counts_about_three_forwards():
    x, w = _meta(128, 128), _meta(8, 128, 128)
    ratio = _grad_flops(_loop_mm, x, w) / count_flops(_loop_mm, x, w)
    assert 2.8 < ratio < 3.3


def test_full_remat_recompute_is_counted():
    x, w = _meta(128, 128), _meta(8, 2, 128, 128)

    def mk(remat):
        body = apply_remat(
            lambda h, wi: torch.relu(h @ wi[0]) @ wi[1], remat)

        def f(x, w):
            for i in range(w.shape[0]):
                x = body(x, w[i])
            return x
        return f

    plain = _grad_flops(mk("none"), x, w)
    remat = _grad_flops(mk("full"), x, w)
    assert remat > 1.1 * plain


def test_recorded_tally_gives_the_ring_bytes():
    """An all-reduce of f32[1024] over a 4-way axis and an all-gather of
    bf16[8, 128] into [8, 2048] over a 16-way axis, on ``meta`` under a
    sizes-only sharder: 2 (n-1)/n and (n-1)/n of their bytes on the
    wire."""
    s = Sharder({"data": 4, "model": 16}, base_rules(False))
    with record_collectives() as calls:
        r = s.all_reduce(_meta(1024, dtype=torch.float32), "data",
                         downstream="same")
        g = s.all_gather(_meta(8, 128), "model", 1, downstream="same")
    assert r.shape == (1024,) and g.shape == (8, 2048)
    stats = ra.collective_stats(calls)
    assert stats.by_op["all-reduce"] == 1024 * 4 * 2 * (3 / 4)
    assert stats.by_op["all-gather"] == 8 * 2048 * 2 * (15 / 16)
    assert stats.count == 2
    assert [(c.op, c.bytes, c.group) for c in calls] == [
        ("all-reduce", 4096, 4), ("all-gather", 8 * 2048 * 2, 16)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_the_reference(arch):
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        want = jra.model_flops_estimate(jget(arch), kind, seq, batch)
        got = ra.model_flops_estimate(tget(arch), kind, seq, batch)
        assert abs(got - want) <= 1e-12 * want, (arch, kind, got, want)


def test_meta_storages_are_freed_and_the_peak_is_tracked():
    """The finalizer on a ``meta`` storage fires when its last tensor
    goes, a view keeping it alive; the tally's live bytes follow."""
    fired = []
    y = _meta(1000, dtype=torch.float32)
    weakref.finalize(y.untyped_storage(), fired.append, 1)
    v = y.view(10, 100)
    del y
    gc.collect()
    assert not fired
    del v
    gc.collect()
    assert fired == [1]

    def f(x):
        a = x * 2           # 4 KB
        b = a + 1           # 4 KB
        del a               # freed: 4 KB live
        return (b * 3).sum()  # 4 KB more, then 4 bytes

    x = _meta(1024, dtype=torch.float32)
    with Tally() as t:
        f(x)
    assert t.peak_bytes == 2 * 4096 + 4
    assert t.live == 0


# ---------------------------------------------------------------------------
# TinyLlama against the reference's jaxpr
# ---------------------------------------------------------------------------


def _walk(jaxpr, mult=1.0, acc=None):
    """The reference's matmul FLOPs and ``pallas_call`` count, scans times
    their length (``jaxpr_flops``'s rules)."""
    acc = {"dot": 0.0, "pallas": 0.0} if acc is None else acc
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            acc["dot"] += mult * _dot_flops(eqn)
        elif prim == "conv_general_dilated":
            acc["dot"] += mult * _conv_flops(eqn)
        elif prim == "pallas_call":
            acc["pallas"] += mult
        elif prim == "scan":
            _walk(eqn.params["jaxpr"].jaxpr, mult * eqn.params["length"], acc)
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                inner = eqn.params.get(key)
                if inner is not None:
                    _walk(getattr(inner, "jaxpr", inner), mult, acc)
                    break
    return acc


def _reference(policy, kind, remat="none"):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    cfg = dataclasses.replace(jget("tinyllama_1_1b").with_policy(policy),
                              remat=remat)
    art = jbuild(cfg, mesh)
    if kind == "fwd":
        j = jax.make_jaxpr(art.prefill_step)(
            art.param_shapes, {"tokens": jax.ShapeDtypeStruct((1, 2048),
                                                              jnp.int32)})
    else:
        b = {k: jax.ShapeDtypeStruct((2, 256), jnp.int32)
             for k in ("tokens", "labels")}
        j = jax.make_jaxpr(art.train_step)(art.param_shapes, art.opt_shapes,
                                           b)
    return dict(_walk(j.jaxpr), total=jaxpr_flops(j.jaxpr))


def _port(policy, kind, remat="none"):
    cfg = dataclasses.replace(tget("tinyllama_1_1b").with_policy(policy),
                              remat=remat)
    art = build_artifacts(cfg, device="meta")
    params = art.init_params()
    if kind == "fwd":
        _, t, _ = count(art.prefill_step, params,
                        {"tokens": _meta(1, 2048, dtype=torch.int32)})
    else:
        b = {k: _meta(2, 256, dtype=torch.int32) for k in ("tokens", "labels")}
        _, t, _ = count(art.train_step, params, art.init_opt(params), b)
    return dict(dot=t.dot_flops, pallas=sum(t.kernel_calls.values()),
                total=t.flops)


CASES = [("*=exact", "fwd", "none")] + [
    ("*=exact", "train", m) for m in ("none", "dots", "dots_nb", "full")] + [
    ("*=pc3_tr:pallas", k, m) for k, m in (("fwd", "none"),
                                           ("train", "none"),
                                           ("train", "full"))]


@pytest.mark.parametrize("policy,kind,remat", CASES)
def test_tinyllama_counts_match_the_reference(policy, kind, remat):
    want = _reference(policy, kind, remat)
    got = _port(policy, kind, remat)
    assert got["dot"] == want["dot"], (got, want)
    extra = 22 if remat != "none" else 0  # the last GEMM of each layer
    assert got["pallas"] == want["pallas"] + (
        extra if policy != "*=exact" else 0), (got, want)
    rel = 0.01 if kind == "fwd" else 0.02
    assert abs(got["total"] - want["total"]) <= rel * want["total"], (
        got, want)
