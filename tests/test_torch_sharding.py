"""Port parity: the sharding rules, the Sharder's specs, each parameter's
logical axes, and the expert-parallel dispatch (no process group needed).

* ``Sharder.spec`` equals the reference's ``tuple(Sharder.spec(...))`` for
  every parameter of all 13 ids at full size, under ``base_rules`` for
  training and serving, with ``seq_sharded_cache`` and
  ``sp_activations``, on meshes {model: 4}, {data: 2, model: 2} and
  {pod: 2, data: 16, model: 16}. The reference's ``Sharder`` reads only
  ``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in mesh is
  enough on its side; the port's takes a sizes-only dict.
* ``param_axes()`` equals the reference's
  ``axes_tree(*model.init(key, abstract=True))``.
* ``tests/test_sharding.py``'s cases, mirrored.
* ``_capacity`` and ``_local_dispatch_compute`` equal the reference's in
  f32 within 1e-6 of max |out|, and ``moe_ffn``'s EP path on a 1x1 mesh
  equals the reference's on a directly built 1x1 ``Mesh`` the same way.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCH_IDS, PAPER_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.module import Ctx as JCtx  # noqa: E402
from repro.models.module import axes_tree as jaxes_tree  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import shard_params  # noqa: E402
from repro_torch.models.module import Ctx as TCtx  # noqa: E402
from repro_torch.models.module import flatten  # noqa: E402
from repro_torch.models.registry import build_model as tbuild  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.parallel import sharding as TSH  # noqa: E402

IDS = ARCH_IDS + PAPER_IDS
MESHES = ({"model": 4}, {"data": 2, "model": 2},
          {"pod": 2, "data": 16, "model": 16})
RULES = (dict(), dict(serve=True), dict(seq_sharded_cache=True),
         dict(sp_activations=True))


def _jmesh(sizes):
    """The two attributes the reference's Sharder reads."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _jflat(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jflat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), v


@pytest.fixture(scope="module")
def trees():
    """{id: (reference shapes, reference axes, port specs)} at full size."""
    out = {}
    for arch in IDS:
        shapes, axes = jbuild(jget(arch)).init(jax.random.PRNGKey(0),
                                               abstract=True)
        out[arch] = (dict(_jflat(shapes)),
                     dict(_jflat(jaxes_tree(shapes, axes))),
                     tbuild(tget(arch), device="cpu").param_specs())
    return out


@pytest.mark.parametrize("arch", IDS)
def test_param_axes_equal_the_reference(trees, arch):
    _, jaxes, _ = trees[arch]
    got = flatten(tbuild(tget(arch), device="cpu").param_axes())
    assert got == jaxes


@pytest.mark.parametrize("arch", IDS)
def test_specs_equal_the_reference_for_every_parameter(trees, arch):
    jshapes, jaxes, tspecs = trees[arch]
    assert set(tspecs) == set(jshapes)
    n = 0
    for sizes in MESHES:
        for kw in RULES:
            rules = TSH.base_rules("pod" in sizes, **kw)
            assert rules == JSH.base_rules("pod" in sizes, **kw)
            js = JSH.Sharder(_jmesh(sizes), rules)
            ts = TSH.Sharder(sizes, rules)
            for path, spec in tspecs.items():
                want = tuple(js.spec(jaxes[path], jshapes[path].shape))
                assert ts.spec(spec.axes, spec[0]) == want, (path, sizes, kw)
                n += want != ()
    assert arch in PAPER_IDS or n > 0  # something is actually sharded


def test_paged_cache_axes_and_tree_shardings_equal_the_reference():
    assert DecoderLM.paged_cache_axes() == JDecoderLM.paged_cache_axes()
    cfg = tget("qwen3_moe_235b")
    m = tbuild(cfg, device="cpu")
    sizes = {"data": 2, "model": 2}
    ts = TSH.Sharder(sizes, TSH.base_rules(False, serve=True))
    shapes = {p: types.SimpleNamespace(shape=s[0])
              for p, s in m.param_specs().items()}
    from repro_torch.models.module import unflatten
    got = flatten(TSH.tree_shardings(ts, unflatten(shapes), m.param_axes()))
    js = JSH.Sharder(_jmesh(sizes), JSH.base_rules(False, serve=True))
    for path, spec in m.param_specs().items():
        assert got[path] == tuple(js.spec(spec.axes, spec[0]))


# -- tests/test_sharding.py, mirrored --------------------------------------

def test_spec_basic():
    s = TSH.Sharder({"data": 1}, TSH.base_rules(False))
    # 'model' axis absent from this mesh -> dropped; embed->data kept
    assert s.spec(("embed", "heads"), (64, 32)) == ("data",)


def test_divisibility_fallback():
    s = TSH.Sharder({"model": 1}, {"kv_heads": "model"})
    assert s.spec(("kv_heads",), (4,)) == ("model",)


def test_divisibility_drops_nondividing_axis():
    s = TSH.Sharder({"model": 16}, {"kv_heads": "model"})
    assert s.spec(("kv_heads",), (4,)) == ()      # 4 % 16 != 0 -> replicate
    assert s.spec(("kv_heads",), (32,)) == ("model",)


def test_axis_used_once_per_spec():
    s = TSH.Sharder({"data": 4}, {"a": "data", "b": "data"})
    assert s.spec(("a", "b"), (8, 8)) == ("data",)


def test_seq_cache_rule_switch():
    base = TSH.Sharder({"model": 16}, TSH.base_rules(False))
    seqc = TSH.Sharder({"model": 16},
                       TSH.base_rules(False, seq_sharded_cache=True))
    axes = ("cache_batch", "cache_seq", "act_kv_heads", None)
    assert base.spec(axes, (8, 32768, 4, 64)) == ()
    assert seqc.spec(axes, (8, 32768, 4, 64)) == (None, "model")


def test_constrain_is_the_identity_with_and_without_a_sharder():
    x = torch.arange(6.0).reshape(2, 3)
    assert TSH.constrain(x, ("act_batch", None)) is x
    with TSH.use_sharder(TSH.Sharder({"data": 2}, TSH.base_rules(False))):
        assert TSH.current_sharder() is not None
        assert TSH.constrain(x, ("act_batch", None)) is x
    assert TSH.current_sharder() is None


def test_moe_dense_fallback_without_mesh():
    cfg = tget("dbrx_132b").smoke(n_experts=4, topk=2, d_model=32,
                                  expert_ff=16)
    rng = np.random.default_rng(0)
    p = {"router": torch.from_numpy(rng.normal(size=(32, 4)).astype(
        np.float32))}
    for k, shape in (("w_in", (4, 32, 16)), ("w_gate", (4, 32, 16)),
                     ("w_out", (4, 16, 32))):
        p[k] = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(
        np.float32)).to(torch.bfloat16)
    out, aux = tmoe.moe_ffn(TCtx(p), x, cfg)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()
    assert float(aux) > 0.0


def test_moe_capacity_drops_tokens_gracefully():
    cfg = dataclasses.replace(
        tget("dbrx_132b").smoke(n_experts=4, topk=2, d_model=16,
                                expert_ff=8), capacity_factor=0.25)
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype)

    x2d = rnd(64, 16)
    ids, probs, _ = tmoe._route(x2d, rnd(16, 4, dtype=torch.float32), cfg)
    out = tmoe._local_dispatch_compute(x2d, ids, probs, rnd(4, 16, 8),
                                       rnd(4, 16, 8), rnd(4, 8, 16), 0, cfg)
    assert out.shape == (64, 16) and torch.isfinite(out.float()).all()
    # with drops, some rows are exactly zero (token fully dropped)
    assert int((out.float() == 0).all(dim=1).sum()) > 0


# -- shards ---------------------------------------------------------------

def test_shard_index_is_major_axis_first_and_shards_reassemble():
    s = TSH.Sharder({"pod": 2, "data": 3, "model": 2},
                    TSH.base_rules(True))
    t = torch.arange(12 * 4 * 6, dtype=torch.float32).reshape(12, 4, 6)
    spec = s.spec(("embed", "mlp", None), t.shape)
    assert spec == (("pod", "data"), "model")
    assert s.local_shape(t.shape, spec) == (2, 2, 6)
    rows = []
    for pod in range(2):
        for data in range(3):
            c = {"pod": pod, "data": data, "model": 1}
            assert TSH.shard_index(s, spec[0], c) == pod * 3 + data
            rows.append(TSH.shard_tensor(s, t, spec, c))
    np.testing.assert_array_equal(torch.cat(rows).numpy(), t[:, 2:].numpy())


def test_shard_params_cuts_every_leaf_by_its_spec():
    cfg = tget("qwen3_moe_235b").smoke(n_layers=2, kv_heads=4)
    m = tbuild(cfg, device="cpu")
    full = m.init(0)
    s = TSH.Sharder({"model": 4}, TSH.base_rules(False, serve=True))
    specs = m.param_specs()
    for r in range(4):
        loc = flatten(shard_params(full, s, {"model": r}, model=m))
        for path, t in flatten(full).items():
            spec = s.spec(specs[path].axes, t.shape)
            assert loc[path].shape == s.local_shape(t.shape, spec)
            torch.testing.assert_close(
                loc[path], TSH.shard_tensor(s, t, spec, {"model": r}),
                rtol=0, atol=0)
    # w_in (L, E, d, ff): experts split over model; the router stays whole
    w_in = flatten(shard_params(full, s, {"model": 3}, model=m))[
        "blocks/ffn/w_in"]
    assert torch.equal(w_in, flatten(full)["blocks/ffn/w_in"][:, 3:4])


# -- expert parallelism against the reference -----------------------------

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _moe_inputs(cfg, seed=0, tokens=(2, 8)):
    rng = np.random.default_rng(seed)
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_ff
    return {"x": rng.normal(size=(*tokens, d)).astype(np.float32),
            "router": rng.normal(size=(d, e)).astype(np.float32),
            "w_in": (rng.normal(size=(e, d, ff)) / 8).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, ff)) / 8).astype(np.float32),
            "w_out": (rng.normal(size=(e, ff, d)) / 8).astype(np.float32)}


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("tokens", [4, 9, 64])
def test_capacity_equals_the_reference(tokens):
    for cf in (0.25, 1.0, 1.25, 4.0):
        cfg = dataclasses.replace(tget("qwen3_moe_235b").smoke(),
                                  capacity_factor=cf)
        jcfg = dataclasses.replace(jget("qwen3_moe_235b").smoke(),
                                   capacity_factor=cf)
        assert tmoe._capacity(tokens, cfg) == jmoe._capacity(tokens, jcfg)


@pytest.mark.parametrize("cf,e0", [(0.25, 0), (1.25, 0), (1.25, 2),
                                   (4.0, 2)])
def test_local_dispatch_compute_equals_the_reference(cf, e0):
    """Two of four experts held locally (``e0``), the same routing fed to
    both packages (f32, exact expert GEMMs)."""
    cfg = dataclasses.replace(tget("dbrx_132b").smoke(**F32),
                              capacity_factor=cf)
    jcfg = dataclasses.replace(jget("dbrx_132b").smoke(**F32),
                               capacity_factor=cf)
    a = _moe_inputs(cfg)
    x2d = a["x"].reshape(-1, cfg.d_model)
    ids, probs, _ = jmoe._route(jnp.asarray(x2d), jnp.asarray(a["router"]),
                                jcfg)
    w = {k: a[k][e0:e0 + 2] for k in ("w_in", "w_gate", "w_out")}
    want = jmoe._local_dispatch_compute(
        jnp.asarray(x2d), ids, probs, *(jnp.asarray(w[k]) for k in
                                        ("w_in", "w_gate", "w_out")), e0,
        jcfg)
    got = tmoe._local_dispatch_compute(
        torch.from_numpy(x2d), torch.from_numpy(np.array(ids)).long(),
        torch.from_numpy(np.array(probs)),
        *(torch.from_numpy(w[k]) for k in ("w_in", "w_gate", "w_out")), e0,
        cfg)
    _close(got.numpy(), want)
    if cf < 1:
        assert (np.asarray(want) == 0).all(axis=1).sum() > 0


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_ffn_ep_on_a_1x1_mesh_equals_the_reference(cf):
    """The EP branch (capacity dropping) on one rank: the reference's
    ``shard_map`` on a 1x1 ``Mesh`` of its one CPU device; the port under
    a sizes-only {data: 1, model: 1} sharder (no collective runs)."""
    cfg = dataclasses.replace(tget("dbrx_132b").smoke(**F32),
                              capacity_factor=cf)
    jcfg = dataclasses.replace(jget("dbrx_132b").smoke(**F32),
                               capacity_factor=cf)
    a = _moe_inputs(cfg, seed=1)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jp = {k: jnp.asarray(v) for k, v in a.items() if k != "x"}
    with JSH.use_sharder(JSH.Sharder(mesh, JSH.base_rules(False))):
        want, jaux = jmoe.moe_ffn(JCtx("apply", params=jp),
                                  jnp.asarray(a["x"]), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    with TSH.use_sharder(TSH.Sharder({"data": 1, "model": 1},
                                     TSH.base_rules(False))):
        got, taux = tmoe.moe_ffn(TCtx(tp), torch.from_numpy(a["x"]), cfg)
    _close(got.numpy(), want)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the dense path (no sharder) is the same function only without drops
    # (capacity 0.5: 8 slots an expert for 32 routed slots)
    dense, _ = tmoe.moe_ffn(TCtx(tp), torch.from_numpy(a["x"]), cfg)
    assert (np.abs(dense.numpy() - got.numpy()).max() <= 1e-5) == (cf >= 4)
