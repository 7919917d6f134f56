"""Bodies that the multi-rank port tests run on each rank of a ``gloo``
group (``repro_torch.launch.mesh.run_ranks``). They import neither jax nor
the JAX package: a spawned rank imports this module by name, so it stays
light. Every body takes the rank first and returns picklable values."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.module import unflatten
from repro_torch.models.registry import build_model
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               poisson_requests)

TIERS = (("free", "*=pc3_tr"), ("paid", "*=exact"))
# the reference's sharded serving scenarios (tests/test_serve_multidevice.py)
SCENARIOS = {
    "mixed": dict(engine=dict(num_slots=4, max_seq=48, block_size=8,
                              prefill_chunk=8, tiers=TIERS),
                  reqs=dict(rate=0.5, base_gen=10, seed=0)),
    "preempt": dict(engine=dict(num_slots=4, max_seq=48, block_size=8,
                                num_blocks=8, prefill_chunk=8, tiers=TIERS,
                                preempt=True),
                    reqs=dict(rate=1.0, base_gen=14, seed=1)),
    "spec": dict(engine=dict(num_slots=4, max_seq=48, block_size=8,
                             num_blocks=8, prefill_chunk=8, tiers=TIERS,
                             preempt=True, spec_draft="*=pc3_tr", spec_k=3),
                 reqs=dict(rate=1.0, base_gen=14, seed=1)),
}


def load_params(npz_path, cfg):
    """The JAX package's parameters, saved flat (``a/b/c`` keys)."""
    with np.load(npz_path) as f:
        tree = unflatten({k: f[k] for k in f.files})
    return params_from_jax(tree, cfg, device="cpu")


def serve(cfg, params, engine_kw, reqs, shards):
    """Serve ``reqs`` (fresh Request copies) under a ``shards``-way
    ``model`` mesh; the outputs and the engine's counters."""
    mesh = make_mesh((shards,), ("model",))
    engine = ServeEngine(build_model(cfg, device="cpu"), params,
                         EngineConfig(shards=shards, **engine_kw), mesh=mesh,
                         device="cpu")
    rep = engine.run([Request(prompt=list(r.prompt),
                              max_new_tokens=r.max_new_tokens,
                              arrival_step=r.arrival_step, policy=r.policy)
                      for r in reqs])
    return dict(outputs={s.request_id: list(s.output)
                         for s in rep.completed},
                preemptions=rep.preemptions, resumes=rep.resumes,
                spec_steps=rep.spec_steps, shards=rep.shards,
                blocks_in_use=engine.pool.stats()["blocks_in_use"],
                report=engine.resolution_report())


def tp_scenarios(rank, npz_path, cfg_kw, names):
    """The reference's sharded scenarios on this rank's shards."""
    cfg = get_config("tinyllama_1_1b").smoke(**cfg_kw)
    params = load_params(npz_path, cfg)
    out = {}
    for name in names:
        sc = SCENARIOS[name]
        reqs = poisson_requests(6, cfg.vocab, base_prompt=7,
                                tiers=["free", "paid"], **sc["reqs"])
        out[name] = serve(cfg, params, sc["engine"], reqs, shards=4)
    return out


def moe_serve(rank, npz_path, cfg_kw, policy, engine_kw, runs, shards):
    """An MoE id served tensor- and expert-parallel, once for each named
    workload in ``runs``: lists of (prompt, max_new_tokens, arrival_step)."""
    cfg = get_config("qwen3_moe_235b").smoke(**cfg_kw).with_policy(policy)
    params = load_params(npz_path, cfg)
    return {name: serve(cfg, params, engine_kw,
                        [Request(prompt=p, max_new_tokens=n, arrival_step=a)
                         for p, n, a in reqs], shards=shards)
            for name, reqs in runs.items()}


def moe_ep(rank, arrays, cfg_kw, mesh_shape, mesh_axes):
    """``moe_ffn`` under a sharder over ``mesh_shape``: the rank's shards of
    the whole weights, the whole ``x``; returns (out, aux) as numpy."""
    from repro_torch.models.moe import EXPERT_IN_AXES, EXPERT_OUT_AXES
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.module import Ctx
    from repro_torch.parallel.sharding import (Sharder, base_rules,
                                               shard_tensor, use_sharder)

    cfg = get_config("dbrx_132b").smoke(**cfg_kw)
    mesh = make_mesh(mesh_shape, mesh_axes)
    sharder = Sharder(mesh, base_rules("pod" in mesh_axes))
    axes = {"router": ("embed", None), "w_in": EXPERT_IN_AXES,
            "w_gate": EXPERT_IN_AXES, "w_out": EXPERT_OUT_AXES}
    coords = sharder.coords()
    params = {k: shard_tensor(sharder, torch.from_numpy(v),
                              sharder.spec(axes[k], v.shape), coords)
              for k, v in arrays.items() if k != "x"}
    with use_sharder(sharder), torch.no_grad():
        out, aux = moe_ffn(Ctx(params), torch.from_numpy(arrays["x"]), cfg)
    return out.numpy(), float(aux)


def collectives(rank, world, grads, modes, pipe, ep, ep_cfg, ep_meshes):
    """``compressed_psum`` of this rank's ``grads[rank]`` in each mode over
    a ``data`` dim, ``pipeline_apply`` over a ``stage`` dim, and
    :func:`moe_ep` on each of ``ep_meshes`` ({name: (shape, axes,
    config overrides)})."""
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh((world,), ("data",))
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    psum = {m: {k: v.numpy() for k, v in
                compressed_psum(g, "data", m, mesh=mesh).items()}
            for m in modes}
    stage = make_mesh((world,), ("stage",))
    params = {k: torch.from_numpy(v) for k, v in pipe["params"].items()}
    x = torch.from_numpy(pipe["x"])

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    piped = {m: pipeline_apply(layer, params, x, stage,
                               n_microbatches=m).numpy()
             for m in pipe["microbatches"]}
    return psum, piped, {name: moe_ep(rank, ep, dict(ep_cfg, **over), shape,
                                      axes)
                         for name, (shape, axes, over) in ep_meshes.items()}
