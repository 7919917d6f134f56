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
    """``moe_ffn`` under a sharder over ``mesh_shape`` (the train rules):
    the rank's shards of the whole weights and its rows of ``x``; returns
    (out, the rows gathered whole; aux) as numpy."""
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
    rows = sharder.spec(("act_batch",), arrays["x"].shape)
    x = shard_tensor(sharder, torch.from_numpy(arrays["x"]), rows, coords)
    with use_sharder(sharder), torch.no_grad():
        out, aux = moe_ffn(Ctx(params), x, cfg)
        out = sharder.all_gather(out, rows[0] if rows else None, 0,
                                 downstream="same")
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


# ---------------------------------------------------------------------------
# multi-device training (tests/test_torch_dist_train.py, _dist_moe.py)
# ---------------------------------------------------------------------------

def _policy(kind):
    from repro_torch.core.config import DaismConfig, Variant
    from repro_torch.policy import ApproxPolicy

    if kind == "exact":
        return "*=exact"
    return ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                            backward=kind))


def extra_inputs(family, batch, seed, *, n_image_tokens, enc_frames,
                 d_model):
    """The float inputs a VLM (``image_embeds``) or Whisper (``frames``)
    batch carries beside its tokens: seeded normals, the same arrays in
    both packages' runs (``tests/jax_dist_train.py`` imports this)."""
    rng = np.random.default_rng(seed)
    if family == "vlm":
        return {"image_embeds": rng.normal(
            size=(batch, n_image_tokens, d_model)).astype(np.float32)}
    if family == "audio":
        return {"frames": rng.normal(
            size=(batch, enc_frames, d_model)).astype(np.float32)}
    return {}


def draws(cfg, run):
    """``lm_batches`` of the run with each draw's extra inputs; the first
    draw lays out the batch sharding, as the reference's launcher's."""
    from repro_torch.data import lm_batches

    for i, b in enumerate(lm_batches(cfg.vocab, run["batch"], run["seq"],
                                     seed=0)):
        yield dict(b, **extra_inputs(
            cfg.family, run["batch"], i, n_image_tokens=cfg.n_image_tokens,
            enc_frames=cfg.enc_frames, d_model=cfg.d_model))


def _whole(art, params):
    """Every leaf gathered whole (a collective), as numpy."""
    from repro_torch.models.module import flatten

    lay = flatten(art.param_shardings)
    return {k: lay[k].gather(t).numpy() for k, t in flatten(params).items()}


def train_run(run, init_dir, mesh, ckpt_dir=None):
    """One run of ``tests/jax_dist_train.py``'s spec on this rank's shards
    of the reference's initial weights (``mesh`` None: one device, the
    sizes-only sharder): per-step loss and grad norm, AdamW's first moment
    after step 1 and the final parameters, gathered whole; with
    ``ckpt_dir`` the parameters are also saved there."""
    import os

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data import shard_batch
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.convert import shard_params

    cfg = get_config(run["arch"]).smoke(**run["cfg"]).with_policy(
        _policy(run["kind"]))
    art = build_artifacts(cfg, mesh, device="cpu", warmup=run["warmup"],
                          total_steps=run["total"])
    params = load_params(os.path.join(init_dir, f"init_{run['arch']}.npz"),
                         cfg)
    if mesh is not None:
        params = shard_params(params, art.sharder, model=art.model)
    opt = art.init_opt(params)
    gen = draws(cfg, run)
    first = next(gen)
    bsh = art.batch_sharding(first) if mesh is not None else None
    losses, gnorms = [], []
    for i in range(run["steps"]):
        params, opt, m = art.train_step(
            params, opt, shard_batch(next(gen), bsh, device="cpu"))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i == 0:  # a copy: the steps after update the moments in place
            m1 = {k: v.copy() for k, v in _whole(art, opt.m).items()}
    if ckpt_dir is not None:
        ckpt.save(ckpt_dir, run["steps"], {"params": params},
                  {"params": art.param_shardings})
    return dict(loss=losses, grad_norm=gnorms, m1=m1,
                params=_whole(art, params))


def decode_run(run, init_dir, mesh):
    """``tests/jax_dist_train.py``'s ``decode_run`` on this rank's shards:
    ``prefill_step`` on the first draw's rows, then ``decode_step`` over
    its tokens from an empty ``init_cache`` (this rank's rows and kv
    heads; Whisper's ``enc`` from ``encode``); both logits with the rows
    gathered whole."""
    import os

    from repro_torch.data import shard_batch
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.convert import shard_params
    from repro_torch.parallel.sharding import use_sharder

    cfg = get_config(run["arch"]).smoke(**run["cfg"]).with_policy(
        _policy(run["kind"]))
    art = build_artifacts(cfg, mesh, device="cpu")
    params = shard_params(load_params(
        os.path.join(init_dir, f"init_{run['arch']}.npz"), cfg),
        art.sharder, model=art.model)
    batch = next(draws(cfg, run))
    bsh = art.batch_sharding(batch)
    rows = bsh["tokens"]
    sharded = shard_batch(batch, bsh, device="cpu")
    prefill = art.prefill_step(params, sharded)
    b, s = batch["tokens"].shape
    cache = art.init_cache(b, s)
    if cfg.family == "audio":
        with use_sharder(art.sharder), torch.no_grad():
            cache["enc"] = art.model.encode(params, sharded["frames"])
    extra = sharded.get("image_embeds")
    steps = []
    for t in range(s):
        logits, cache = art.decode_step(params, sharded["tokens"][:, t:t + 1],
                                        cache, extra)
        steps.append(logits[:, 0])
    return dict(prefill=rows.gather(prefill).numpy(),
                decode=rows.gather(torch.stack(steps, 1)).numpy())


def train_runs(rank, runs, init_dir, mesh_shape, ckpt_root=None):
    """Each run on one (data, model) mesh (a ``decode`` run:
    :func:`decode_run`); rank 0 returns the results."""
    import os

    mesh = make_mesh(mesh_shape, ("data", "model"))
    out = {}
    for run in runs:
        if run.get("decode"):
            out[run["name"]] = decode_run(run, init_dir, mesh)
            continue
        d = (os.path.join(ckpt_root, run["ckpt"])
             if ckpt_root and run.get("ckpt") else None)
        out[run["name"]] = train_run(run, init_dir, mesh, d)
    return out if rank == 0 else None


def restore_2x2(rank, cfg_kw, dirs, step):
    """Restore each checkpoint of ``dirs`` onto a 2x2 mesh with
    ``param_shardings``: every rank's shards against the stored arrays
    (bit for bit), and the restored tree gathered whole (rank 0)."""
    import os

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.module import flatten

    cfg = get_config("tinyllama_1_1b").smoke(**cfg_kw)
    art = build_artifacts(cfg, make_mesh((2, 2), ("data", "model")),
                          device="cpu")
    like = art.init_params(1)
    out = {}
    for name, d in dirs.items():
        back = ckpt.restore(d, step, {"params": like},
                            {"params": art.param_shardings})["params"]
        lay = flatten(art.param_shardings)
        with np.load(os.path.join(d, f"step_{step:08d}",
                                  "arrays.npz")) as f:
            for k, t in flatten(back).items():
                want = lay[k].shard(torch.from_numpy(f["params/" + k]))
                assert torch.equal(t, want), (name, k)
        out[name] = _whole(art, back)
    return out if rank == 0 else None


def grad_sites(rank, arrays, cases):
    """The gradient through each kind of sharded call site on this rank's
    mesh, of ``sum(out * G)`` over its own rows: ``mlp`` (column-parallel
    ``wi``/``wg``, row-parallel ``wo``, FSDP gathers), ``row_whole_x`` (a
    row-parallel K sliced from a whole ``x``), ``lm`` (vocab-parallel
    ``embed`` then ``unembed``) and ``ep`` (``moe_ffn``'s expert-parallel
    path, capacity that drops nothing). Rank 0 returns every gradient
    gathered whole: weights over their specs, inputs over their rows."""
    from repro_torch.models.layers import (FFN_AXES, embed, mlp,
                                           sharded_dot, unembed)
    from repro_torch.models.module import Ctx
    from repro_torch.models.moe import (EXPERT_IN_AXES, EXPERT_OUT_AXES,
                                        moe_ffn)
    from repro_torch.parallel.sharding import (NamedSharding, Sharder,
                                               base_rules, use_sharder)
    from repro_torch.policy import OpKind

    axes = {"wi": FFN_AXES["wi"], "wg": FFN_AXES["wg"],
            "wo": FFN_AXES["wo"], "embedding": ("vocab", "embed"),
            "lm_head": ("embed", "vocab"), "router": ("embed", None),
            "w_in": EXPERT_IN_AXES, "w_gate": EXPERT_IN_AXES,
            "w_out": EXPERT_OUT_AXES, "w_row": ("mlp", "embed")}
    out = {}
    for name, (kind, shape, serve) in cases.items():
        mesh = make_mesh(shape, ("data", "model"))
        sharder = Sharder(mesh, base_rules(False, serve=serve))
        cfg = get_config(
            "dbrx_132b" if kind == "ep" else "tinyllama_1_1b").smoke(
            param_dtype="float32", compute_dtype="float32", vocab=64,
            capacity_factor=2.0)
        lay = {k: NamedSharding(sharder, sharder.spec(axes[k], v.shape))
               for k, v in arrays.items() if k in axes}
        w = {k: lay[k].shard(torch.from_numpy(v)).requires_grad_()
             for k, v in arrays.items() if k in axes}
        rows = NamedSharding(sharder, sharder.spec(("act_batch",),
                                                   arrays["x"].shape))
        g = rows.shard(torch.from_numpy(arrays["g_" + kind]))
        with use_sharder(sharder), torch.enable_grad():
            if kind == "lm":
                toks = rows.shard(torch.from_numpy(arrays["tokens"]))
                y = unembed(Ctx(w), embed(Ctx(w), toks, cfg), cfg)
                ins = []
            else:
                x = rows.shard(torch.from_numpy(
                    arrays["h" if kind == "row_whole_x" else "x"]))
                x.requires_grad_()
                ins = [x]
                if kind == "mlp":
                    y = mlp(Ctx(w), x, cfg)
                elif kind == "row_whole_x":
                    y, _ = sharded_dot(cfg, x, w["w_row"], name="w_row",
                                       kind=OpKind.DENSE,
                                       axes=axes["w_row"],
                                       shape=arrays["w_row"].shape)
                else:
                    y, _ = moe_ffn(Ctx(w), x, cfg)
            used = {k: t for k, t in w.items()
                    if k in {"mlp": ("wi", "wg", "wo"),
                             "row_whole_x": ("w_row",),
                             "lm": ("embedding", "lm_head"),
                             "ep": ("router", "w_in", "w_gate",
                                    "w_out")}[kind]}
            got = torch.autograd.grad((y * g).sum(), ins + list(used.values()))
        res = {k: lay[k].gather(d).numpy()
               for k, d in zip(used, got[len(ins):])}
        if ins:
            res["x"] = rows.gather(got[0]).numpy()
        out[name] = res
    return out if rank == 0 else None


def pipeline_grads(rank, pipe):
    """``pipeline_apply``'s gradient of ``sum(out**2)`` over a ``stage``
    mesh of every rank, for each microbatch count: (w, b, x) gradients."""
    import torch.distributed as dist

    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh((dist.get_world_size(),), ("stage",))
    out = {}
    for m in pipe["microbatches"]:
        p = {k: torch.from_numpy(pipe["params"][k]).requires_grad_()
             for k in ("w", "b")}
        x = torch.from_numpy(pipe["x"]).requires_grad_()
        y = pipeline_apply(lambda q, h: torch.tanh(h @ q["w"] + q["b"]), p,
                           x, mesh, n_microbatches=m)
        out[m] = [t.numpy() for t in torch.autograd.grad(
            (y ** 2).sum(), [p["w"], p["b"], x])]
    return out


def four_ranks(rank, restore_args, pipe, grad_args, moe_args):
    """The 4-rank jobs of the training tests, in one group: restores onto
    2x2, the pipeline's gradient, the call sites' gradients and the MoE
    runs on 2x2 (each None to skip)."""
    return dict(
        restore=restore_2x2(rank, *restore_args) if restore_args else None,
        pipe=pipeline_grads(rank, pipe) if pipe else None,
        grads=grad_sites(rank, *grad_args) if grad_args else None,
        moe=train_runs(rank, *moe_args) if moe_args else None)


def tally_step(rank, arch, cfg_kw, batch, mesh_shape):
    """One ``train_step`` of a smoke config over a (data, model) mesh from
    ``init_params(0)``, its group calls noted
    (``parallel.sharding.record_collectives``); rank 0 returns them as
    (op, bytes, group, wire bytes) tuples."""
    import dataclasses

    from repro_torch.data import shard_batch
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.parallel.sharding import record_collectives

    mesh = make_mesh(mesh_shape, ("data", "model"))
    art = build_artifacts(get_config(arch).smoke(**cfg_kw), mesh,
                          device="cpu")
    params = art.init_params(0)
    opt = art.init_opt(params)
    rows = shard_batch(batch, art.batch_sharding(batch), device="cpu")
    with record_collectives() as calls:
        art.train_step(params, opt, rows)
    return [dataclasses.astuple(c) for c in calls] if rank == 0 else None


def families(rank, runs, init_dir, mesh_shape, tally=None):
    """:func:`train_runs` on one mesh and, with ``tally`` (the arguments
    of :func:`tally_step` after the rank), the noted train step; rank 0
    returns both."""
    out = train_runs(rank, runs, init_dir, mesh_shape)
    calls = tally_step(rank, *tally) if tally else None
    return (out, calls) if rank == 0 else None
