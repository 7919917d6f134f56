"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
        --smoke --steps 200 --batch 8 --seq 64 --ckpt /path/to/ckpt

The flags and defaults are the JAX launcher's (``repro.launch.train``),
plus ``--device`` (``cuda``, the default, or ``cpu``), ``--layers`` (cut
the depth, never the width) and ``--log-every``. Fault tolerance: re-running
the same command resumes from the newest complete checkpoint in ``--ckpt``
(``runtime/fault_tolerance.py``), which the JAX package's ``restore``
reads as well. Before any weight is built, the daism-lint preflight
(``repro_torch.analyze.preflight``) checks the (model, policy) pair for the
target ``--device`` and aborts on an error finding; ``--no-preflight``
skips it.

``--devices N`` / ``--mesh DxM|auto`` train over a ``data`` x ``model``
mesh of N ranks (FSDP + tensor parallel, ``launch/steps.py``); ``auto`` is
the reference's ``best_effort_mesh(model_parallel=1 if N == 1 else 2)``,
and a mesh without ``--devices`` takes D x M ranks. On the CPU the
launcher spawns N ``gloo`` ranks (``launch/mesh.py::run_ranks``); on the
card one ``nccl`` rank a card, or it joins the group ``torchrun
--nproc-per-node N`` brings up, and N beyond the cards raises; it never
falls back to the CPU. Rank 0 prints the mesh and the step lines. Without
either flag the run takes one device and no process group.
"""
import argparse
import contextlib
import dataclasses
import io
import os
import sys
import tempfile
import warnings


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (CPU-trainable)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--devices", type=int, default=0,
                   help="ranks to train on (0: one device, no mesh; with "
                        "--mesh DxM, D*M)")
    p.add_argument("--mesh", default="auto",
                   help="'auto' | 'DATAxMODEL' e.g. 4x2")
    p.add_argument("--daism", default="exact",
                   help="DEPRECATED (use --policy): uniform multiplier "
                        "variant for parameter GEMMs "
                        "(exact|fla|hla|pc2|pc3|pc2_tr|pc3_tr)")
    p.add_argument("--policy", default="",
                   help="per-site approximation policy spec, e.g. "
                        "'*/layer_0/*=exact,@lm_head=exact,*=pc3_tr:pallas'")
    p.add_argument("--no-preflight", action="store_true",
                   help="skip the daism-lint static preflight")
    p.add_argument("--device", default="cuda",
                   help="where the model trains (cuda | cpu)")
    p.add_argument("--layers", type=int, default=0,
                   help="depth override (0 = the config's); width is kept")
    p.add_argument("--log-every", type=int, default=10,
                   help="print the step's metrics every N steps")
    args = p.parse_args(argv)
    ranks = _ranks(args)

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.config import Backend, DaismConfig, Variant

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.policy:
        cfg = cfg.with_policy(args.policy)
    elif args.daism != "exact":
        warnings.warn("--daism is deprecated; use --policy "
                      f"'*={args.daism}'", DeprecationWarning, stacklevel=1)
        cfg = dataclasses.replace(
            cfg, daism=DaismConfig(variant=Variant(args.daism),
                                   backend=Backend.JNP))
    if not args.no_preflight:
        # static lint of the (model, policy) pair before any weight exists:
        # zero-match rules and illegal backends fail here in seconds
        # (launch/lint.py standalone)
        from repro_torch.analyze import preflight

        preflight(cfg, serving=False, device=args.device,
                  label=f"train {args.arch}")

    if ranks > 1 and not dist.is_initialized() \
            and "WORLD_SIZE" not in os.environ:
        # linted once, here: the ranks skip the preflight
        argv = sys.argv[1:] if argv is None else list(argv)
        return _spawn(args, ranks, argv + ["--no-preflight"])
    device, mesh, quiet, own_group = args.device, None, None, False
    if ranks:
        from repro_torch.launch.mesh import init_distributed

        own_group = not dist.is_initialized()
        device = init_distributed(args.device,
                                  world_size=None if "WORLD_SIZE"
                                  in os.environ else ranks)
        if dist.get_world_size() != ranks:
            raise SystemExit(f"--devices {ranks} needs as many ranks; the "
                             f"process group has {dist.get_world_size()}")
        mesh = _mesh(args, ranks)
        if dist.get_rank():
            quiet = io.StringIO()
    try:
        with contextlib.redirect_stdout(quiet) if quiet is not None \
                else contextlib.nullcontext():
            return _train(args, cfg, device, mesh)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _ranks(args) -> int:
    """The ranks the flags ask for (0: one device, no mesh); raises the
    reference's errors for a mesh the ranks do not fill."""
    if args.mesh == "auto":
        n = args.devices
        if n > 1 and n % 2:
            raise ValueError(f"{n} devices not divisible by TP=2")
        return n
    try:
        d, m = (int(x) for x in args.mesh.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: 'auto' or DATAxMODEL, "
                         "e.g. 4x2") from None
    if args.devices and args.devices != d * m:
        raise ValueError(f"mesh {args.mesh} needs {d * m} devices; "
                         f"--devices {args.devices}")
    return d * m


def _mesh(args, ranks: int):
    from repro_torch.launch.mesh import best_effort_mesh, make_mesh

    if args.mesh == "auto":
        return best_effort_mesh(model_parallel=1 if ranks == 1 else 2)
    d, m = (int(x) for x in args.mesh.split("x"))
    return make_mesh((d, m), ("data", "model"))


def _train(args, cfg, device, mesh):
    from repro_torch.data import lm_batches, shard_batch
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault_tolerance import TrainLoopConfig, run

    art = build_artifacts(cfg, mesh, device=device,
                          opt_cfg=AdamWConfig(lr=args.lr),
                          total_steps=args.steps,
                          warmup=max(args.steps // 20, 1))
    dev = art.model.device
    sizes = ({"data": 1, "model": 1} if mesh is None else
             dict(zip(mesh.mesh_dim_names, mesh.shape)))
    print(f"device: {dev} ({cfg.n_layers} layers, d_model {cfg.d_model}); "
          f"mesh: {sizes}")
    params = art.init_params(0)
    opt = art.init_opt(params)
    gen = lm_batches(cfg.vocab, args.batch, args.seq, seed=0)
    first = next(gen)  # the reference draws one batch to lay out its sharding
    bsh = art.batch_sharding(first) if mesh is not None else None

    def put(b):
        return shard_batch(b, bsh, device=dev)

    def log(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}", flush=True)

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                           ckpt_every=args.ckpt_every,
                           log_every=args.log_every)
    params, opt, state = run(
        loop, art.train_step, params, opt, gen, put, metrics_hook=log,
        param_shardings=None if mesh is None else art.param_shardings,
        opt_shardings=None if mesh is None else art.opt_shardings)
    print(f"done at step {state.step}; stragglers seen: {state.stragglers}")
    if args.policy or args.daism != "exact":
        from repro_torch.policy import site_report

        print(site_report(cfg.approx_policy))
    return params, opt, state


def _rank_main(rank, argv):
    """One rank of a spawned run (the launcher itself, in the group
    :func:`_spawn` brought up): its loop state."""
    return main(argv)[2]


def _spawn(args, ranks: int, argv):
    """Run the launcher on ``ranks`` ranks (gloo on the CPU, nccl a card
    each on CUDA); returns (None, None, rank 0's loop state)."""
    import torch

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.runtime.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        have = torch.cuda.device_count()
        if ranks > have:
            raise SystemExit(
                f"--devices {ranks} does not divide the {have} available "
                "devices (one card a rank; or run under torchrun)")
    state = run_ranks(_rank_main, ranks, argv, device=args.device,
                      quiet=True, timeout_s=3600.0)[0]
    return None, None, state


if __name__ == "__main__":
    main()
