#!/usr/bin/env python3
"""Where the MoE ids' STE training departs from the reference, and why.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 tools/moe_ste_drift.py [--meshes]

Qwen3-MoE and DBRX smoke configs (f32, 2 layers, vocab 128), PC3_TR with
the STE backward, B = 8, S = 16, warmup 1, 3 steps: the runs of
``tests/test_torch_dist_moe.py``. Prints one JSON object a line:

* ``product``: the PC3_TR product as a function of its operands: the share
  of 200000 seeded products that change when one f32 operand moves by
  one ulp, and the largest relative change (the exact product: at most
  one ulp).
* ``routing`` (each id): the port (no mesh) against the reference (a 1x1
  ``Mesh``) step by step: the relative gaps of the loss and the grad
  norm, and for every router call the tokens whose top-k experts differ
  and the slots past capacity on each side.
* ``self`` (each id): the port against itself with every initial weight
  moved by one ulp at random (4 draws): the loss and grad norm gaps step
  by step, and the step-1 gradient (AdamW's first moment after step 1)
  as one vector and its worst leaf.
* ``--meshes``: the same runs on 1x1, 2x2 and 4x2 against the reference
  on the same mesh (``tests/jax_dist_train.py`` on 8 fake host devices,
  the port on 4 and 8 ``gloo`` ranks by ``tests/torch_ranks.py``): the
  gaps step by step, the step-1 gradient's, the final parameters'. About
  3 minutes on 8 cores.

Outside the test suite. CPU numbers, not a device's.
"""
import argparse
import json
import os
import sys
import tempfile

import numpy as np

ARCHS = ("qwen3_moe_235b", "dbrx_132b")
F32 = dict(n_layers=2, vocab=128, param_dtype="float32",
           compute_dtype="float32")
B, S, STEPS = 8, 16, 3


def emit(**rec):
    print(json.dumps(rec), flush=True)


def product():
    import torch

    from repro_torch.core.config import Variant
    from repro_torch.core.floatmul import approx_mul_to_f32

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(200000, generator=g), torch.randn(200000, generator=g)
    x2 = torch.nextafter(x, torch.full_like(x, np.inf))
    p = approx_mul_to_f32(x, w, Variant.PC3_TR)
    p2 = approx_mul_to_f32(x2, w, Variant.PC3_TR)
    rel = ((p2 - p).abs() / p.abs()).max()
    exact = (((x2 * w) - (x * w)).abs() / (x * w).abs()).max()
    emit(part="product", changed_share=float((p2 != p).float().mean()),
         max_rel_change=float(rel), exact_max_rel_change=float(exact))


def _policies():
    from repro.core.config import DaismConfig as JConfig
    from repro.core.config import Variant as JVariant
    from repro.policy import ApproxPolicy as JPolicy
    from repro_torch.core.config import DaismConfig, Variant
    from repro_torch.policy import ApproxPolicy

    return (JPolicy.uniform(JConfig(variant=JVariant.PC3_TR, backward="ste")),
            ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                             backward="ste")))


def _dropped(ids, cfg):
    cap = max(int(np.ceil(ids.shape[0] * cfg.topk / cfg.n_experts
                          * cfg.capacity_factor)), cfg.topk)
    cnt = np.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(cnt - cap, 0).sum())


def routing(arch):
    import jax
    import jax.numpy as jnp

    import repro.models.moe as jmoe
    import repro_torch.models.moe as tmoe
    from repro.configs import get_config as jget
    from repro.launch.steps import build_artifacts as jbuild
    from repro.models.registry import build_model as jmodel
    from repro_torch.configs import get_config as tget
    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.convert import params_from_jax

    jrec, trec = [], []
    j_route, t_route = jmoe._route, tmoe._route

    def jroute(x2d, w, cfg):
        ids, probs, aux = j_route(x2d, w, cfg)
        jax.debug.callback(lambda i: jrec.append(np.asarray(i)), ids)
        return ids, probs, aux

    def troute(x2d, w, cfg):
        ids, probs, aux = t_route(x2d, w, cfg)
        trec.append(ids.detach().numpy().copy())
        return ids, probs, aux

    jmoe._route, tmoe._route = jroute, troute
    try:
        jpol, tpol = _policies()
        tcfg = tget(arch).smoke(**F32).with_policy(tpol)
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        ja = jbuild(jget(arch).smoke(**F32).with_policy(jpol), mesh,
                    warmup=1, total_steps=100)
        ta = build_artifacts(tcfg, device="cpu", warmup=1, total_steps=100)
        p, _ = jmodel(jget(arch).smoke(**F32)).init(jax.random.PRNGKey(0))
        npp = jax.tree.map(np.asarray, p)
        jp = jax.tree.map(jnp.asarray, npp)
        tp = params_from_jax(npp, tcfg, device="cpu")
        jo, to = ja.init_opt(jp), ta.init_opt(tp)
        gen = lm_batches(128, B, S, seed=0)
        next(gen)  # the draw that lays out the batch sharding in the tests
        for step in range(STEPS):
            batch = next(gen)
            nj, nt = len(jrec), len(trec)
            jp, jo, jm = ja.train_step(jp, jo, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
            jax.block_until_ready(jm["loss"])
            tp, to, tm = ta.train_step(tp, to, batch)
            calls = [dict(other_experts=int((np.sort(ji, -1) != np.sort(
                ti, -1)).any(-1).sum()), tokens=len(ti),
                dropped_ref=_dropped(ji, tcfg), dropped_port=_dropped(ti, tcfg))
                for ji, ti in zip(jrec[nj:], trec[nt:])]
            emit(part="routing", arch=arch, step=step + 1, **{
                k + "_rel": abs(float(tm[k]) - float(jm[k])) / abs(float(jm[k]))
                for k in ("loss", "grad_norm")}, router_calls=calls)
    finally:
        jmoe._route, tmoe._route = j_route, t_route


def self_sensitivity(arch, draws=4):
    import torch

    from repro_torch.configs import get_config as tget
    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.models.module import flatten

    cfg = tget(arch).smoke(**F32).with_policy(_policies()[1])

    def run(seed):
        art = build_artifacts(cfg, device="cpu", warmup=1, total_steps=100)
        params = art.init_params(0)
        if seed is not None:
            g = torch.Generator().manual_seed(seed)
            for t in flatten(params).values():
                up = torch.nextafter(t, torch.full_like(t, np.inf))
                t.copy_(torch.where(torch.rand(t.shape, generator=g) < 0.5,
                                    up, t))
        opt = art.init_opt(params)
        gen = lm_batches(128, B, S, seed=0)
        next(gen)
        out, m1 = [], None
        for i in range(STEPS):
            params, opt, m = art.train_step(params, opt, next(gen))
            out.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                m1 = {k: v.clone() for k, v in flatten(opt.m).items()}
        return np.array(out), m1

    base, bm = run(None)
    norm = np.sqrt(sum(float((v ** 2).sum()) for v in bm.values()))
    for seed in range(draws):
        got, gm = run(seed)
        rel = np.abs(got - base) / np.abs(base)
        leaf = {k: float((gm[k] - bm[k]).norm() / bm[k].norm()) for k in bm}
        worst = max(leaf, key=leaf.get)
        emit(part="self", arch=arch, draw=seed, loss_rel=rel[:, 0].tolist(),
             grad_norm_rel=rel[:, 1].tolist(),
             grad1_rel=float(np.sqrt(sum(float(((gm[k] - bm[k]) ** 2).sum())
                                         for k in bm)) / norm),
             grad1_worst_leaf=worst, grad1_worst_rel=leaf[worst])


def meshes():
    import torch_ranks
    from repro_torch.launch.mesh import run_ranks
    from test_torch_dist_train import reference_runs

    runs = [dict(name=f"{a}_{m[0]}x{m[1]}", arch=a, cfg=F32, kind="ste",
                 mesh=list(m), warmup=1, total=100, batch=B, seq=S,
                 steps=STEPS)
            for a in ARCHS for m in ((1, 1), (2, 2), (4, 2))]
    with tempfile.TemporaryDirectory() as d:
        ref = reference_runs(d, runs, timeout=900)
        port = {}
        for shape, n in (((4, 2), 8), ((2, 2), 4)):
            port.update(run_ranks(
                torch_ranks.train_runs, n,
                [r for r in runs if tuple(r["mesh"]) == shape], d, shape,
                timeout_s=900)[0])
        for r in runs:
            if r["mesh"] == [1, 1]:
                port[r["name"]] = torch_ranks.train_run(r, d, None)
        for r in runs:
            got, want = port[r["name"]], ref[r["name"]]
            with np.load(os.path.join(d, f"init_{r['arch']}.npz")) as f:
                init = {k: f[k] for k in f.files}
            rel = {k: (np.abs(np.asarray(got[k]) - want[k])
                       / np.abs(want[k])).tolist()
                   for k in ("loss", "grad_norm")}
            leaf = {k: float(np.linalg.norm(got["m1"][k] - want["m1/" + k])
                             / np.linalg.norm(want["m1/" + k]))
                    for k in got["m1"]}
            worst = max(leaf, key=leaf.get)
            p = got["params"]
            err = np.sqrt(sum(np.sum((p[k] - want["p/" + k]) ** 2)
                              for k in p))
            moved = np.sqrt(sum(np.sum((want["p/" + k] - init[k]) ** 2)
                                for k in p))
            emit(part="mesh", arch=r["arch"], mesh=r["mesh"],
                 loss_rel=rel["loss"], grad_norm_rel=rel["grad_norm"],
                 grad1_worst_leaf=worst, grad1_worst_rel=leaf[worst],
                 params_rel=float(err / moved))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--meshes", action="store_true",
                   help="also the runs on 1x1, 2x2 and 4x2 (gloo ranks)")
    p.add_argument("--threads", type=int, default=2)
    args = p.parse_args()
    import torch

    torch.set_num_threads(args.threads)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "tests"))
    product()
    for arch in ARCHS:
        routing(arch)
        self_sensitivity(arch)
    if args.meshes:
        meshes()


if __name__ == "__main__":
    main()
