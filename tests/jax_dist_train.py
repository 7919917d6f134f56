"""The reference's side of the port's multi-device training tests: run in a
subprocess with 8 fake host devices (``python tests/jax_dist_train.py
<out_dir> <spec json>``), on directly built ``jax.sharding.Mesh``es (Auto
axes; ``jax.make_mesh`` makes Explicit ones, which the reference's
sharding constraints refuse).

For each run of the spec it builds the reference's ``build_artifacts`` on
a (data, model) mesh of the first D x M devices, loads the initial
parameters (drawn once, on one device, and saved for the port to load),
takes the steps on ``lm_batches(vocab, B, S, seed=0)`` (a VLM's and
Whisper's float inputs beside, ``torch_ranks.extra_inputs``) after the one
draw that lays out the batch sharding, as the reference's launcher does, and
saves the per-step loss and grad norm, AdamW's first moment after step 1
(0.1 x the clipped gradient at the initial weights) and the final
parameters. A run
with ``ckpt`` saves its final parameters as a checkpoint and restores it
onto a 2x2 mesh (elastic restore). A run with ``decode`` trains nothing:
it saves ``prefill_step``'s logits on the first draw and those of S
``decode_step``s from an empty cache (sharded by ``cache_shardings_for``;
Whisper's ``enc`` filled by ``encode``) fed that draw's tokens one by one.
Prints REFERENCE-OK.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.checkpoint import checkpoint as ckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core.config import DaismConfig, Variant  # noqa: E402
from repro.data.synthetic import lm_batches, shard_batch  # noqa: E402
from repro.launch.steps import build_artifacts  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.policy import ApproxPolicy  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_ranks import extra_inputs  # noqa: E402


def flat(tree, pre=""):
    for k, v in tree.items():
        p = pre + "/" + k if pre else k
        if isinstance(v, dict):
            yield from flat(v, p)
        else:
            yield p, np.asarray(v)


def unflat(d):
    tree = {}
    for path, v in d.items():
        *scopes, leaf = path.split("/")
        t = tree
        for k in scopes:
            t = t.setdefault(k, {})
        t[leaf] = v
    return tree


def policy(kind):
    if kind == "exact":
        return "*=exact"
    return ApproxPolicy.uniform(DaismConfig(variant=Variant.PC3_TR,
                                            backward=kind))


def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))


def decode_run(art, params, batch, bsh):
    """``prefill_step`` on ``batch``, then ``decode_step`` over its tokens
    from an empty cache: the logits of both, (B, S, V) each."""
    model, cfg = art.model, art.cfg
    b, s = batch["tokens"].shape
    sharded = shard_batch(batch, bsh)
    prefill = np.asarray(art.prefill_step(params, sharded))
    cache = model.init_cache(b, s)
    if cfg.family == "audio":
        cache["enc"] = model.encode(params, sharded["frames"])
    cache = jax.device_put(cache, art.cache_shardings_for(cache))
    extra = sharded.get("image_embeds")
    steps = []
    for t in range(s):
        tok = jax.device_put(batch["tokens"][:, t:t + 1], bsh["tokens"])
        logits, cache = art.decode_step(params, tok, cache, extra)
        steps.append(np.asarray(logits)[:, 0])
    return {"prefill": prefill, "decode": np.stack(steps, 1)}


def main(out_dir, spec):
    assert jax.device_count() == 8, jax.devices()
    inits = {}
    for run in spec["runs"]:
        name, arch = run["name"], run["arch"]
        cfg = get_config(arch).smoke(**run["cfg"])
        if arch not in inits:  # one draw a config, on one device
            p, _ = build_model(cfg).init(jax.random.PRNGKey(0))
            inits[arch] = dict(flat(p))
            np.savez(os.path.join(out_dir, f"init_{arch}.npz"),
                     **inits[arch])
        art = build_artifacts(cfg.with_policy(policy(run["kind"])),
                              mesh_of(run["mesh"]), warmup=run["warmup"],
                              total_steps=run["total"])
        params = jax.device_put(unflat(inits[arch]), art.param_shardings)
        opt = art.init_opt(params)
        gen = (dict(b, **extra_inputs(
            cfg.family, run["batch"], i, n_image_tokens=cfg.n_image_tokens,
            enc_frames=cfg.enc_frames, d_model=cfg.d_model))
            for i, b in enumerate(lm_batches(cfg.vocab, run["batch"],
                                             run["seq"], seed=0)))
        first = next(gen)
        bsh = art.batch_sharding(first)
        if run.get("decode"):
            np.savez(os.path.join(out_dir, f"{name}.npz"),
                     **decode_run(art, params, first, bsh))
            continue
        losses, gnorms, m1 = [], [], {}
        for i in range(run["steps"]):
            params, opt, m = art.train_step(params, opt,
                                            shard_batch(next(gen), bsh))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if i == 0:
                m1 = {"m1/" + k: v for k, v in flat(opt.m)}
        out = {"loss": np.array(losses), "grad_norm": np.array(gnorms), **m1}
        out.update({"p/" + k: v for k, v in flat(params)})
        if run.get("ckpt"):
            d = os.path.join(out_dir, run["ckpt"])
            ckpt.save(d, run["steps"], {"params": params})
            art2 = build_artifacts(cfg, mesh_of((2, 2)))
            back = ckpt.restore(d, run["steps"],
                                {"params": art2.param_shapes},
                                {"params": art2.param_shardings})["params"]
            out.update({"r/" + k: v for k, v in flat(back)})
        np.savez(os.path.join(out_dir, f"{name}.npz"), **out)
    print("REFERENCE-OK")


if __name__ == "__main__":
    main(sys.argv[1], json.loads(sys.argv[2]))
