"""Port parity: the MoE FFN (``models/moe.py``), its injection point
``policy_expert_matmul`` and the MoE ids (DBRX, Qwen3-MoE) against the JAX
package on converted weights.

Tolerances:
* routing, from the same f32 router inputs: expert ids equal on every
  token whose k-th and (k+1)-th probabilities differ by more than 1e-5
  (and exactly on ties: the lower id first, as ``lax.top_k``), the
  renormalised gates within 1e-6 relative, ``aux`` within 1e-6 relative;
* ``policy_expert_matmul``: exact within 1e-5; approximate, as
  tests/test_kernels.py:41 holds the GEMM (rtol 1e-5, atol 1e-4: the same
  products in another f32 summation order); the resolution log and
  ``site_report`` equal;
* the models: f32 exact within rtol = atol = 1e-4 (tests/test_torch_model.py)
  with greedy tokens identical; approximate policies bounded at ~1.5x the
  measured port-vs-JAX gap, for the reason tests/test_torch_model.py gives
  (carry-boundary jumps amplify 1-ulp framework differences upstream),
  measured values in the comments. ``aux`` of a forward is held the same
  way: the router sees the layer's input, which carries those
  differences.
* the engine: tokens equal to the JAX engine's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as JS  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.config import DaismConfig as JConfig  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.policy import ApproxPolicy as JPolicy  # noqa: E402
from repro.policy import dispatch as jdispatch  # noqa: E402
from repro.policy import parse_policy as jparse  # noqa: E402
from repro.policy import site_scope as jscope  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.config import DaismConfig, Variant  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.policy import ApproxPolicy  # noqa: E402
from repro_torch.policy import dispatch as tdispatch  # noqa: E402
from repro_torch.policy import parse_policy as tparse  # noqa: E402
from repro_torch.policy import site_scope as tscope  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; one intra-op thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE = ("dbrx_132b", "qwen3_moe_235b")
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
BF16 = dict(n_layers=2, vocab=128)
SPECS = ["*=exact", "*=pc3_tr", "*/attn/*=exact,*=pc3_tr"]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,t,seed", [("dbrx_132b", 64, 0),
                                         ("qwen3_moe_235b", 64, 1),
                                         ("qwen3_moe_235b", 300, 2)])
def test_route_matches_jax(arch, t, seed):
    """``_route`` at the id's expert count and top-k (d = 64) from the same
    f32 inputs."""
    cfg = jget(arch)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, 64)).astype(np.float32)
    w = (rng.normal(size=(64, cfg.n_experts)) / 8).astype(np.float32)
    jids, jprobs, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(w), cfg)
    tids, tprobs, taux = tmoe._route(torch.from_numpy(x), torch.from_numpy(w),
                                     tget(arch))
    jids, jprobs = np.asarray(jids), np.asarray(jprobs)
    full = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1)
    top = np.sort(np.asarray(full), -1)[:, ::-1]
    clear = top[:, cfg.topk - 1] - top[:, cfg.topk] > 1e-5
    assert clear.sum() >= t // 2
    np.testing.assert_array_equal(tids.numpy()[clear], jids[clear])
    np.testing.assert_allclose(tprobs.numpy()[clear], jprobs[clear],
                               rtol=1e-6, atol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_route_ties_take_the_lower_expert_id():
    """Equal probabilities: ``lax.top_k``'s order (lower id first), which
    ``torch.topk`` does not promise; the port sorts stably."""
    cfg = tget("qwen3_moe_235b")
    x = np.ones((5, 8), np.float32)
    w = np.zeros((8, cfg.n_experts), np.float32)
    w[:, [3, 7, 40, 90]] = 0.5  # four tied leaders, the rest tied lower
    jids, _, _ = jmoe._route(jnp.asarray(x), jnp.asarray(w), jget(
        "qwen3_moe_235b"))
    tids, _, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[0].tolist() == [3, 7, 40, 90, 0, 1, 2, 4]


def test_router_rows_do_not_depend_on_m():
    """``router_logits``: a row's f32 logits are the same bits whether its
    call holds 1, 4, 128 or 300 rows (one GEMM shape whatever M)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((300, 96), generator=g).to(torch.bfloat16)
    w = torch.randn((96, 16), generator=g)
    big = tmoe.router_logits(x, w)
    for m in (1, 4, 128, 129):
        assert torch.equal(tmoe.router_logits(x[:m], w), big[:m]), m
        assert torch.equal(tmoe.router_logits(x[-m:], w), big[-m:]), m


# ---------------------------------------------------------------------------
# policy_expert_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,dtype", [("*=exact", "float32"),
                                        ("*=pc3_tr", "float32"),
                                        ("*=pc3_tr", "bfloat16"),
                                        ("*=pc3_tr:pallas", "bfloat16")])
def test_policy_expert_matmul_matches_jax(spec, dtype):
    """(E, C, d) x (E, d, f) under the site ``moe/ffn/w_in``: values, the
    resolution log and ``site_report``; the port's ``x`` is the broadcast
    view the dense MoE passes (one (C, d) operand, expert stride 0)."""
    rng = np.random.default_rng(3)
    e, c, d, f = 4, 6, 40, 24
    x = rng.normal(size=(c, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    name = f"expert-{spec}-{dtype}"
    jpol, tpol = jparse(spec, name=name), tparse(spec, name=name)
    jdispatch.clear_log(jpol)
    tdispatch.clear_log(tpol)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    with jscope("moe"), jscope("ffn"):
        ref = jdispatch.policy_expert_matmul(
            jpol, jnp.broadcast_to(jnp.asarray(x, jdt)[None], (e, c, d)),
            jnp.asarray(w, jdt), name="w_in")
    with tscope("moe"), tscope("ffn"):
        got = tdispatch.policy_expert_matmul(
            tpol, torch.from_numpy(x).to(tdt)[None].expand(e, c, d),
            torch.from_numpy(w).to(tdt), name="w_in")
    assert got.dtype == tdt and tuple(got.shape) == (e, c, f)
    ref = np.asarray(ref, np.float32)
    if spec == "*=exact":
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    elif dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    else:  # bf16 outputs: the f32 sums round to bf16 on both sides
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2**-8,
                                   atol=1e-4)
    jlog, tlog = jdispatch.resolution_log(jpol), tdispatch.resolution_log(tpol)
    assert [(p, k.value, m) for (p, k), (_, _, m) in tlog.items()] == \
        [(p, k.value, m) for (p, k), (_, _, m) in jlog.items()] == \
        [("moe/ffn/w_in", "moe_expert", e * c * d * f)]
    assert tdispatch.site_report(tpol) == jdispatch.site_report(jpol)


@pytest.mark.parametrize("backward", ["ste", "approx"])
def test_expert_matmul_gradients_match_jax(backward):
    """The straight-through and the approximate backward of an approximate
    expert site (f32, jnp backend): d/dx and d/dw of sum(out * g)."""
    rng = np.random.default_rng(4)
    e, c, d, f = 3, 5, 32, 16
    x, w, g = (rng.normal(size=s).astype(np.float32)
               for s in ((e, c, d), (e, d, f), (e, c, f)))
    jpol = JPolicy.uniform(JConfig(variant=JVariant.PC3_TR, backward=backward))
    tpol = ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                            backward=backward))
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(jdispatch.policy_expert_matmul(
        jpol, a, b, name="w", record=False) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tdispatch.policy_expert_matmul(tpol, tx, tw, name="w", record=False)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the MoE ids
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def np_params():
    out = {}
    for arch in MOE:
        for key, kw in (("f32", F32), ("bf16", BF16)):
            p, _ = jbuild(jget(arch).smoke(**kw)).init(jax.random.PRNGKey(0))
            out[(arch, key)] = jax.tree.map(np.asarray, p)
    return out


def _models(arch, spec, key, np_params, port_spec=None):
    kw = F32 if key == "f32" else BF16
    jm = jbuild(jget(arch).smoke(**kw).with_policy(spec))
    tcfg = tget(arch).smoke(**kw).with_policy(port_spec or spec)
    p = np_params[(arch, key)]
    return (jm, jax.tree.map(jnp.asarray, p), tbuild(tcfg, device="cpu"),
            params_from_jax(p, tcfg, device="cpu"))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 128, size=(b, s)).astype(
        np.int32)


# (arch, entry point, spec) -> bound on max|dlogits| / max|ref| and on
# |daux| / |aux|; measured port-vs-JAX gaps in the comments
REL = {
    ("dbrx_132b", "forward", "*=pc3_tr"): 7e-3,                    # 4.66e-3
    ("dbrx_132b", "forward", "*/attn/*=exact,*=pc3_tr"): 2.1e-4,   # 1.4e-4
    ("qwen3_moe_235b", "forward", "*=pc3_tr"): 1e-3,               # 6.92e-4
    ("qwen3_moe_235b", "forward", "*/attn/*=exact,*=pc3_tr"): 5.4e-5,  # 3.61e-5
}
# f32 forwards: the 1e-6 of routing from equal inputs holds (measured <=
# 2.3e-7); bf16 ``*=pc3_tr:pallas``: (logits, aux) bounds per id
AUX_REL_F32 = 1e-6
BF16_REL = {"dbrx_132b": (0.085, 5.2e-4),         # 5.61e-2, 3.46e-4
            "qwen3_moe_235b": (0.09, 2.5e-4)}     # 6.00e-2, 1.63e-4


def _close(got, ref, arch, entry, spec):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert got.shape == ref.shape
    if spec == "*=exact":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - ref).max() <= \
            REL[(arch, entry, spec)] * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", MOE)
def test_forward_and_aux_match_jax_f32(arch, spec, np_params):
    jm, jp, tm, tp = _models(arch, spec, "f32", np_params)
    toks = _tokens(2, 12)
    ref, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    _close(ref, got.numpy(), arch, "forward", spec)
    assert float(jaux) > 0 and abs(float(taux) - float(jaux)) <= \
        AUX_REL_F32 * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE)
def test_bf16_pallas_forward_matches_jax(arch, np_params):
    """bf16 ``*=pc3_tr:pallas`` (the expert kernel's plain version here)
    against JAX's ``*=pc3_tr``: logits within ``BF16_REL``, greedy tokens
    equal on every row whose top-2 gap exceeds the bound (one at least),
    ``aux`` within its bound."""
    jm, jp, tm, tp = _models(arch, "*=pc3_tr", "bf16", np_params,
                             port_spec="*=pc3_tr:pallas")
    toks = _tokens(2, 12, seed=2)
    ref, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    rel, aux_rel = BF16_REL[arch]
    bound = rel * np.abs(ref).max()
    assert np.abs(got - ref).max() <= bound
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.sum() >= 1
    np.testing.assert_array_equal(got.argmax(-1)[clear], ref.argmax(-1)[clear])
    assert abs(float(taux) - float(jaux)) <= aux_rel * abs(float(jaux))


def test_site_report_identical_after_one_forward(np_params):
    """A Qwen3-MoE forward under a mixed policy: the resolution log (the
    expert sites' MACs and dims included) and ``site_report`` as the
    reference's."""
    spec = "*/layer_0/*=exact,@lm_head=exact,*=pc3_tr"
    jpol = jparse(spec, name="moe-mixed")
    tpol = tparse(spec, name="moe-mixed")
    jm = jbuild(jget("qwen3_moe_235b").smoke(**F32).with_policy(jpol))
    tcfg = tget("qwen3_moe_235b").smoke(**F32).with_policy(tpol)
    tm = tbuild(tcfg, device="cpu")
    npp = np_params[("qwen3_moe_235b", "f32")]
    tp = params_from_jax(npp, tcfg, device="cpu")
    toks = _tokens(2, 8, seed=5)
    jdispatch.clear_log(jpol)
    tdispatch.clear_log(tpol)
    jm.forward(jax.tree.map(jnp.asarray, npp), {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tm.forward(tp, {"tokens": torch.from_numpy(toks).long()})
    got = tdispatch.site_report(tpol)
    assert "moe_expert" in got and got == jdispatch.site_report(jpol)
    assert tdispatch.estimated_energy_uj(tpol) == \
        jdispatch.estimated_energy_uj(jpol)


def test_engine_tokens_identical_to_jax_engine(np_params):
    """The paged engine on the Qwen3-MoE smoke model (f32, two tiers):
    every request's tokens, group and finish reason as the JAX engine's."""
    tiers = (("free", "*=pc3_tr"), ("paid", "*/attn/*=exact,*=pc3_tr"))
    kw = dict(num_slots=2, max_seq=32, block_size=8, prefill_chunk=8,
              tiers=tiers)
    jm, jp, tm, tp = _models("qwen3_moe_235b", "*=exact", "f32", np_params)

    def reqs(mod):
        return mod.synthetic_requests(5, 128, base_prompt=10, base_gen=6,
                                      seed=1, tiers=["free", "paid"])

    jrep = JS.ServeEngine(jm, jp, JS.EngineConfig(**kw)).run(reqs(JS))
    trep = TS.ServeEngine(tm, tp, TS.EngineConfig(**kw), device="cpu").run(
        reqs(TS))
    assert len(trep.completed) == len(jrep.completed) == 5
    for j, t in zip(jrep.completed, trep.completed):
        assert (t.request_id, t.group, t.finish_reason) == \
            (j.request_id, j.group, j.finish_reason)
        assert t.output == j.output
    assert trep.policy_groups == jrep.policy_groups == 2


def test_launcher_serves_an_moe_id_on_the_cpu(capsys):
    from repro_torch.launch import serve

    report = serve.main(["--arch", "qwen3_moe_235b", "--smoke", "--device",
                         "cpu", "--layers", "2", "--policy",
                         "*=pc3_tr:pallas"])
    out = capsys.readouterr().out
    assert "SMOKE-OK: continuous batching" in out
    assert "ffn/w_in" in out and "moe_expert" in out
    assert len(report.completed) == 6
