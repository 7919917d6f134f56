"""Dry-run on ``meta``: trace every (arch x shape x mesh) cell's step.

The port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell's jitted step for 512 placeholder devices and reads XLA's
analyses; the port has no compiler, so it traces the same step functions
(``launch/steps.py::build_artifacts``, the ones the trainer and the server
run) on ``meta`` tensors, where nothing is allocated or launched, under a
sizes-only sharder of the production mesh (16x16 single-pod, 2x16x16
multi-pod; ``launch/mesh.py``). No process group is needed: the
collectives return their shapes and are noted
(``parallel/sharding.py``).

For every live cell (the reference's mandated skips):

* ``flops_per_device``: the step traced at the cell's global shapes under
  a 1x1 sizes-only sharder, counted by ``roofline/flops.py``, over the
  chips (as the reference's jaxpr count over ``n_chips``);
* ``bytes_per_device``, the collectives and the memory: the step traced on
  one rank's shards under the production mesh's sizes (rank 0 of each
  axis; every rank's shapes are the same); ``arg_bytes`` and
  ``out_bytes`` from the local shapes, ``temp_bytes`` the peak of the
  trace's live storages (``roofline/flops.py``);
* the roofline terms against the H100's datasheet figures
  (``roofline/analysis.py``);
* appended to ``results/dryrun_torch_{tag}.json`` (resumable: done cells
  are skipped unless ``--force``).

``loop_accounting`` is the reference's plan of unroll probes, recorded
per cell; the port runs no probes (its loops are counted by trip count
directly, ``roofline.flops.run_steps``). Rules ``base`` and ``serve`` are
carried out; ``serve`` keeps the decode cache whole along its rows and
its sequence (the reference's serve table splits them over the data
axes and ``model``; the port's cached layers attend on the rows the
activations hold), and ``seqcache`` and ``sp`` raise: the port's layers
do not lay a sequence out over a mesh (ROADMAP C3).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
  ... --arch tinyllama_1_1b --shape train_4k --mesh multi       # one cell
  ... --rules serve                                             # variant
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict

import torch

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results")
RULES = ("base", "serve")


def mesh_sizes(kind: str) -> Dict[str, int]:
    """The production mesh's axis sizes (``launch/mesh.py``): 16x16
    single-pod, 2x16x16 multi-pod."""
    if kind == "multi":
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def rules_for(rules_name: str, multi_pod: bool):
    """The rule table of ``--rules``; names whose layout the port's layers
    do not carry out raise."""
    from repro_torch.parallel.sharding import base_rules

    if rules_name not in RULES:
        raise NotImplementedError(
            f"--rules {rules_name}: the port's layers do not carry out this "
            "layout (a sequence laid out over the model axis: the "
            "sequence-sharded cache of 'seqcache', the sequence-parallel "
            f"activations of 'sp'); one of {RULES} (ROADMAP.md section C, "
            "item 3)")
    rules = base_rules(multi_pod, serve=(rules_name == "serve"))
    if rules_name == "serve":
        # the serve table keeps the decode batch whole on every rank
        # (act_batch); the port's cached layers attend on the rows they
        # hold, so the cache keeps its rows whole too (the reference's
        # table splits them over the data axes, and its sequence over
        # model: ROADMAP C3)
        rules["cache_batch"] = None
    return rules


def loop_accounting(cfg, kind: str, seq: int):
    """The reference's scan-undercount correction plan (a copy): [{cat, k,
    mult}]. The port records it and runs no probes."""
    chunk = cfg.attn_chunk
    cache_len = min(cfg.window, seq) if cfg.window else seq
    kv_len = cache_len if kind == "decode" else seq
    nc = max(1, math.ceil(kv_len / chunk))
    s_time = 1 if kind == "decode" else seq
    probes = []

    def add(cat, k, mult):
        if mult > 0 and k > 1:
            probes.append({"cat": cat, "k": k, "mult": float(mult)})

    fam = cfg.family
    if fam in ("dense", "moe"):
        t = cfg.n_layers
        add("layers", 2, t - 1)
        add("attn", 2, (nc - 1) * t)
    elif fam == "vlm":
        t = cfg.cross_every
        add("layers", t, t - 1)
        add("attn", 2, (nc - 1) * t)
    elif fam == "audio":
        t = cfg.n_layers
        add("layers", 2, t - 1)
        add("attn", 2, (nc - 1) * t)
        if kind != "decode":
            nc_enc = max(1, math.ceil(cfg.enc_frames / chunk))
            add("attn_enc", 2, (nc_enc - 1) * t)
    elif fam == "ssm":
        group = (cfg.slstm_every or cfg.n_layers + 1) - 1
        add("layers", group, group - 1)
        add("time", 2, (s_time - 1) * group)
        add("time_s", 2, (s_time - 1))
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        n_sites = cfg.n_layers // every if every else 0
        if n_sites:
            tail = cfg.n_layers - n_sites * every
            n_loops = n_sites + (1 if tail else 0)
            add("layers", 2, cfg.n_layers - n_loops)
            add("attn", 2, nc - 1)
            add("time", 2, (s_time - 1) * (cfg.n_layers / n_loops))
        else:
            add("layers", 2, cfg.n_layers - 1)
            add("time", 2, (s_time - 1))
    return probes


def _leaf_bytes(tree) -> int:
    from repro_torch.roofline.flops import _tensors_in

    return sum(t.numel() * t.element_size() for t in _tensors_in(tree))


def _local(art, specs):
    """This rank's rows of every batch leaf (``meta``)."""
    shard = art.batch_sharding(specs)
    return {k: torch.empty(art.sharder.local_shape(v.shape, shard[k].spec),
                           dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def cell_args(cfg, mesh, rules, shape):
    """The cell's step and its ``meta`` arguments at this rank's shapes,
    under a sizes-only ``mesh`` (``{axis: size}``; None: 1x1); ``shape``
    names one of ``SHAPES`` or is a (seq, batch, kind) of its own. Returns
    (step, args, kind)."""
    from repro_torch.configs import SHAPES, shape_specs
    from repro_torch.launch.steps import build_artifacts

    seq, batch, kind = SHAPES[shape] if isinstance(shape, str) else shape
    art = build_artifacts(cfg, mesh, device="meta", rules=rules)
    specs, kind = shape_specs(cfg, seq, batch, kind)
    params = art.init_params()
    rows = _local(art, specs)
    if kind == "train":
        return art.train_step, (params, art.init_opt(params), rows), kind
    if kind == "prefill":
        return art.prefill_step, (params, rows), kind
    return art.decode_step, (params, rows.pop("tokens"),
                             art.init_cache(batch, seq),
                             rows.get("image_embeds")), kind


def trace_cell(cfg, mesh, rules, shape):
    """Trace the cell's step (:func:`cell_args`). Returns (its args, its
    output, the tally, the collective calls, kind)."""
    from repro_torch.roofline.flops import count

    fn, args, kind = cell_args(cfg, mesh, rules, shape)
    out, tally, calls = count(fn, *args)
    return args, out, tally, calls, kind


def roofline_record(cfg, shape, sizes: Dict[str, int], rules,
                    arch: str = "", shape_name: str = "",
                    mesh_name: str = "") -> Dict:
    """The record of one cell: ``cfg`` (its ``remat`` as it is) at
    ``shape`` (a ``SHAPES`` name or (seq, batch, kind)) over a mesh of
    ``sizes``, under ``rules`` (module doc)."""
    from repro_torch.configs import SHAPES
    from repro_torch.roofline import analysis as ra

    seq, batch, _ = SHAPES[shape] if isinstance(shape, str) else shape
    n_chips = math.prod(sizes.values())
    t0 = time.monotonic()
    _, _, glob, _, kind = trace_cell(cfg, None, rules, shape)
    t_flops = time.monotonic() - t0
    t0 = time.monotonic()
    args, out, tally, calls, _ = trace_cell(cfg, sizes, rules, shape)
    t_trace = time.monotonic() - t0

    flops_global = glob.flops
    model_flops = ra.model_flops_estimate(cfg, kind, seq, batch)
    roof = ra.analyze(tally, calls, arch=arch, shape=shape_name,
                      mesh_name=mesh_name, n_chips=n_chips,
                      model_flops=model_flops,
                      flops_per_device=flops_global / n_chips)
    arg_bytes = _leaf_bytes(args)
    out_bytes = _leaf_bytes(out)
    temp_bytes = int(tally.peak_bytes)
    return {
        "status": "ok", "kind": kind, "chips": n_chips,
        "lower_s": round(t_flops, 1), "compile_s": round(t_trace, 1),
        "arg_bytes": int(arg_bytes), "out_bytes": int(out_bytes),
        "temp_bytes": temp_bytes,
        "mem_per_device_gb": round(
            (arg_bytes + out_bytes + temp_bytes) / 2**30, 3),
        "flops_per_device": roof.flops_per_device,
        "bytes_per_device": roof.bytes_per_device,
        "wire_bytes_per_device": roof.wire_bytes_per_device,
        "compute_s": roof.compute_s, "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "bottleneck": roof.bottleneck,
        "model_flops": model_flops,
        "useful_ratio": round(model_flops / max(flops_global, 1.0), 4),
        "collective_by_op": {k: round(v)
                             for k, v in roof.collective_by_op.items()},
        "kernel_calls": dict(glob.kernel_calls),
        "probes": loop_accounting(cfg, kind, seq),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             rules_name: str = "base", remat: str = "auto",
             tweaks: str = "", verbose: bool = True) -> Dict:
    from repro_torch.configs import SHAPES, cell_enabled, get_config

    cfg = get_config(arch)
    if not cell_enabled(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip", "reason": "mandated skip (DESIGN.md §4)"}
    kind0 = SHAPES[shape_name][2]
    if remat == "auto":
        remat = "full" if kind0 == "train" else "none"
    cfg = dataclasses.replace(cfg, remat=remat)
    if tweaks:  # e.g. "attn_score_dtype=bfloat16,rnn_state_dtype=bfloat16"
        kv = dict(t.split("=") for t in tweaks.split(","))
        cfg = dataclasses.replace(cfg, **kv)
    rules = rules_for(rules_name, mesh_kind == "multi")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "rules": rules_name, "remat": remat, "tweaks": tweaks}
    rec.update(roofline_record(cfg, shape_name, mesh_sizes(mesh_kind), rules,
                               arch, shape_name, mesh_kind))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind} ({rules_name})] "
              f"trace {rec['lower_s'] + rec['compile_s']:.1f}s mem/dev "
              f"{rec['mem_per_device_gb']}GB terms "
              f"c={rec['compute_s']:.4f}s m={rec['memory_s']:.4f}s "
              f"coll={rec['collective_s']:.4f}s -> {rec['bottleneck']} "
              f"useful={rec['useful_ratio']:.2f}", flush=True)
    return rec


def _result_path(tag: str) -> str:
    os.makedirs(RESULTS, exist_ok=True)
    return os.path.join(RESULTS, f"dryrun_torch_{tag}.json")


def load_results(tag: str = "main") -> Dict[str, Dict]:
    path = _result_path(tag)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def main(argv=None):
    from repro_torch.configs import ARCH_IDS, SHAPES

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    p.add_argument("--rules", default="base")
    p.add_argument("--remat", default="auto")
    p.add_argument("--tweaks", default="")
    p.add_argument("--tag", default="main")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    results = load_results(args.tag)
    path = _result_path(args.tag)
    t0 = time.monotonic()
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = (f"{arch}|{shape}|{mesh_kind}|{args.rules}|"
                       f"{args.remat}|{args.tweaks}")
                if key in results and not args.force \
                        and results[key].get("status") in ("ok", "skip"):
                    continue
                try:
                    rec = run_cell(arch, shape, mesh_kind,
                                   rules_name=args.rules, remat=args.remat,
                                   tweaks=args.tweaks)
                except Exception as e:  # record failures: they are bugs
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "rules": args.rules, "tweaks": args.tweaks,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                results[key] = rec
                with open(path, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skip")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"dry-run: {n_ok} ok, {n_skip} mandated skips, {n_err} errors "
          f"({time.monotonic() - t0:.1f} s)")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
