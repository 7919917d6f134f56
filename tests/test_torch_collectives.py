"""Port parity: the collectives modules (``optim/grad_compress.py``,
``parallel/pipeline.py``) and ``moe_ffn``'s expert-parallel path across
ranks, against the reference's ``shard_map`` runs.

The reference runs in a subprocess on 4 fake host devices with directly
built ``Mesh``es (Auto axes: ``jax.make_mesh`` makes Explicit ones, which
the reference's sharding constraints refuse); the port on 4 ``gloo`` ranks
(``tests/torch_ranks.py`` under ``run_ranks``: one torch thread a rank, a
deadline, a 60 s group timeout), and on one rank in this process with a
sizes-only mesh (no collective runs) and on a 1-rank gloo group.

Tolerances: ``compressed_psum`` ``int8`` bit for bit (the same scale, the
same rounding, an exact integer sum), ``none`` within f32 ordering (rtol
1e-6), ``bf16`` within one bf16 rounding (an ulp, 2^-7, of the summed
magnitudes);
``pipeline_apply`` equals the sequential loop and the reference's 4-stage
pipeline to 1e-6; EP outputs within 1e-6 of max |out|, aux within 1e-6.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.compat import shard_map  # noqa: E402
from repro.optim.grad_compress import compressed_psum as jpsum  # noqa: E402
from repro.parallel.pipeline import pipeline_apply as jpipe  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.optim.grad_compress import compressed_psum  # noqa: E402
from repro_torch.optim.grad_compress import quantize_int8  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: E402

import torch_ranks  # noqa: E402

MODES = ("none", "bf16", "int8")
MICRO = (2, 4, 8)
EP_CFG = dict(param_dtype="float32", compute_dtype="float32",
              capacity_factor=0.75)
# (mesh shape, axes, config overrides): EP on each mesh, and the dense MoE
# under a mesh (its expert weights gathered whole first)
EP_MESHES = {"1x4": ((1, 4), ("data", "model"), {}),
             "2x2": ((2, 2), ("data", "model"), {}),
             "dense 1x4": ((1, 4), ("data", "model"), {"moe_impl": "dense"})}


def _inputs():
    rng = np.random.default_rng(0)
    grads = [{"a": (rng.normal(size=(8, 16)) * (r + 1)).astype(np.float32),
              "b": rng.normal(size=(33,)).astype(np.float32)}
             for r in range(4)]
    L, B, D = 8, 16, 32
    pipe = {"params": {"w": (rng.normal(size=(L, D, D)) / np.sqrt(D)
                             ).astype(np.float32),
                       "b": (rng.normal(size=(L, D)) * 0.1
                             ).astype(np.float32)},
            "x": rng.normal(size=(B, D)).astype(np.float32),
            "microbatches": MICRO}
    cfg = dataclasses.replace(tget("dbrx_132b").smoke(), **EP_CFG)
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.expert_ff
    ep = {"x": rng.normal(size=(2, 8, d)).astype(np.float32),
          "router": rng.normal(size=(d, e)).astype(np.float32),
          "w_in": (rng.normal(size=(e, d, ff)) / 8).astype(np.float32),
          "w_gate": (rng.normal(size=(e, d, ff)) / 8).astype(np.float32),
          "w_out": (rng.normal(size=(e, ff, d)) / 8).astype(np.float32)}
    return grads, pipe, ep


GRADS, PIPE, EP = _inputs()

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import get_config
    from repro.models import moe
    from repro.models.module import Ctx
    from repro.optim.grad_compress import compressed_psum
    from repro.parallel.pipeline import pipeline_apply
    from repro.parallel.sharding import Sharder, base_rules, use_sharder

    inp, spec = np.load(sys.argv[1]), json.loads(sys.argv[3])
    devs = np.array(jax.devices())
    assert devs.size == 4
    out = {}
    mesh = Mesh(devs.reshape(4), ("data",))
    stacked = {k: jnp.asarray(inp["g_" + k]) for k in ("a", "b")}
    for mode in spec["modes"]:
        def body(g, mode=mode):
            g = jax.tree.map(lambda a: a[0], g)
            return jax.tree.map(lambda a: a[None],
                                compressed_psum(g, "data", mode))
        res = shard_map(body, mesh=mesh, in_specs=(P("data"),),
                        out_specs=P("data"), check_vma=False)(stacked)
        for k, v in res.items():
            out["psum_%s_%s" % (mode, k)] = np.asarray(v)
    smesh = Mesh(devs.reshape(4), ("stage",))
    params = {"w": jnp.asarray(inp["pw"]), "b": jnp.asarray(inp["pb"])}
    layer = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
    for m in spec["micro"]:
        out["pipe_%d" % m] = np.asarray(pipeline_apply(
            layer, params, jnp.asarray(inp["px"]), smesh, n_microbatches=m))
    cfg = dataclasses.replace(get_config("dbrx_132b").smoke(),
                              **spec["ep_cfg"])
    p = {k: jnp.asarray(inp["e_" + k])
         for k in ("router", "w_in", "w_gate", "w_out")}
    for name, (shape, axes, over) in spec["ep_meshes"].items():
        emesh = Mesh(devs.reshape(shape), tuple(axes))
        with use_sharder(Sharder(emesh, base_rules(False))):
            o, aux = moe.moe_ffn(Ctx("apply", params=p),
                                 jnp.asarray(inp["e_x"]),
                                 dataclasses.replace(cfg, **over))
        out["ep_" + name], out["aux_" + name] = np.asarray(o), np.asarray(aux)
    np.savez(sys.argv[2], **out)
    print("REFERENCE-OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("coll")
    arrays = {"g_" + k: np.stack([g[k] for g in GRADS]) for k in ("a", "b")}
    arrays.update(pw=PIPE["params"]["w"], pb=PIPE["params"]["b"],
                  px=PIPE["x"], **{"e_" + k: v for k, v in EP.items()})
    np.savez(d / "in.npz", **arrays)
    spec = dict(modes=MODES, micro=MICRO, ep_cfg=EP_CFG,
                ep_meshes=EP_MESHES)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(spec)],
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert "REFERENCE-OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(d / "out.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port():
    """The port's 4-rank run: the collectives, then EP on each mesh;
    ``[(psum, piped, ep)]`` by rank."""
    return run_ranks(torch_ranks.collectives, 4, 4, GRADS, MODES, PIPE, EP,
                     EP_CFG, EP_MESHES, timeout_s=200)


def _sequential(pipe):
    h = torch.from_numpy(pipe["x"])
    for i in range(pipe["params"]["w"].shape[0]):
        h = torch.tanh(h @ torch.from_numpy(pipe["params"]["w"][i])
                       + torch.from_numpy(pipe["params"]["b"][i]))
    return h.numpy()


def _check_psum(mode, got, want, grads):
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    elif mode == "none":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        # one bf16 ulp (2^-7 relative) of the summed magnitudes, over n:
        # the sums add in another order, and a partial sum can be much
        # larger than the result
        scale = sum(np.abs(g) for g in grads) / len(grads)
        assert (np.abs(got - want) <= 2.0**-7 * scale + 1e-30).all()


@pytest.mark.parametrize("mode", MODES)
def test_compressed_psum_on_4_ranks_matches_the_reference(reference, port,
                                                          mode):
    for rank, (psum, _, _) in enumerate(port):
        for k in ("a", "b"):
            _check_psum(mode, psum[mode][k],
                        reference[f"psum_{mode}_{k}"][rank],
                        [g[k] for g in GRADS])


@pytest.mark.parametrize("mode", MODES)
def test_compressed_psum_on_1_rank_matches_the_reference(mode):
    """One device: the reference's shard_map on a 1-device ``Mesh``; the
    port with a sizes-only mesh. The mean over one rank is its gradient,
    up to compression."""
    g = GRADS[1]
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = shard_map(lambda t: jpsum(t, "data", mode), mesh=mesh,
                     in_specs=(P(),), out_specs=P(), check_vma=False)(
        {k: jnp.asarray(v) for k, v in g.items()})
    got = compressed_psum({k: torch.from_numpy(v) for k, v in g.items()},
                          "data", mode, mesh={"data": 1})
    for k in g:
        _check_psum(mode, got[k].numpy(), np.asarray(want[k]), [g[k]])
        assert got[k].dtype == torch.float32


def test_quantize_int8_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 400.0, -400.0])
    assert quantize_int8(x, torch.tensor(1.0)).tolist() == \
        [0, 2, 2, 0, 127, -127]


@pytest.mark.parametrize("m", MICRO)
def test_pipeline_on_4_stages_matches_sequential_and_reference(reference,
                                                               port, m):
    seq = _sequential(PIPE)
    np.testing.assert_allclose(reference[f"pipe_{m}"], seq, rtol=1e-6,
                               atol=1e-6)
    for _, piped, _ in port:
        np.testing.assert_allclose(piped[m], seq, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(piped[m], reference[f"pipe_{m}"],
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_on_one_stage_is_the_sequential_loop():
    params = {k: torch.from_numpy(v) for k, v in PIPE["params"].items()}
    out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                         params, torch.from_numpy(PIPE["x"]),
                         {"stage": 1}, n_microbatches=4)
    np.testing.assert_array_equal(out.numpy(), _sequential(PIPE))
    ref = jpipe(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                {k: jnp.asarray(v) for k, v in PIPE["params"].items()},
                jnp.asarray(PIPE["x"]),
                Mesh(np.array(jax.devices()[:1]), ("stage",)),
                n_microbatches=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_one_gloo_rank_matches_the_reference():
    """The same rank body on a 1-rank gloo group (collectives over groups
    of one): compressed_psum against the reference's shard_map on one
    device, the one-stage pipeline against the sequential loop, and EP on
    a 1x1 mesh against the reference's on a 1x1 ``Mesh``."""
    g = GRADS[0]
    ((psum, piped, ep),) = run_ranks(
        torch_ranks.collectives, 1, 1, [g], MODES, PIPE, EP, EP_CFG,
        {"1x1": ((1, 1), ("data", "model"), {})}, timeout_s=200)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    for mode in MODES:
        want = shard_map(lambda t, mode=mode: jpsum(t, "data", mode),
                         mesh=mesh, in_specs=(P(),), out_specs=P(),
                         check_vma=False)(
            {k: jnp.asarray(v) for k, v in g.items()})
        for k in g:
            _check_psum(mode, psum[mode][k], np.asarray(want[k]), [g[k]])
    for m in MICRO:
        np.testing.assert_array_equal(piped[m], _sequential(PIPE))
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.models.module import Ctx as JCtx
    from repro.parallel import sharding as JSH

    jcfg = dataclasses.replace(jget("dbrx_132b").smoke(), **EP_CFG)
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with JSH.use_sharder(JSH.Sharder(one, JSH.base_rules(False))):
        want, jaux = jmoe.moe_ffn(
            JCtx("apply", params={k: jnp.asarray(v) for k, v in EP.items()
                                  if k != "x"}), jnp.asarray(EP["x"]), jcfg)
    out, aux = ep["1x1"]
    want = np.asarray(want)
    assert np.abs(out - want).max() <= 1e-6 * max(np.abs(want).max(), 1e-30)
    assert abs(aux - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("name", sorted(EP_MESHES))
def test_moe_ep_on_4_ranks_matches_the_reference(reference, port, name):
    """Experts over a 4-way model axis (1x4), and experts over 2 with the
    contraction dim gathered and the batch split over 2 data ranks (2x2),
    at a capacity factor that drops tokens; and ``moe_impl="dense"`` under
    the 1x4 mesh, the dense MoE on the gathered weights."""
    want, jaux = reference["ep_" + name], float(reference["aux_" + name])
    scale = max(np.abs(want).max(), 1e-30)
    for _, _, ep in port:
        out, aux = ep[name]
        assert np.abs(out - want).max() <= 1e-6 * scale
        assert abs(aux - jaux) <= 1e-6 * abs(jaux)
