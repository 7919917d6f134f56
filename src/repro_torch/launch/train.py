"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
        --smoke --steps 200 --batch 8 --seq 64 --ckpt /path/to/ckpt

The flags and defaults are the JAX launcher's (``repro.launch.train``),
plus ``--device`` (``cuda``, the default, or ``cpu``), ``--layers`` (cut
the depth, never the width) and ``--log-every``. Training runs on one
device: ``--devices`` and ``--mesh`` take only one (``0``/``1``,
``auto``/``1x1``). Fault tolerance: re-running the same command resumes
from the newest complete checkpoint in ``--ckpt``
(``runtime/fault_tolerance.py``), which the JAX package's ``restore``
reads as well. Before any weight is built, the daism-lint preflight
(``repro_torch.analyze.preflight``) checks the (model, policy) pair for the
target ``--device`` and aborts on an error finding; ``--no-preflight``
skips it.
"""
import argparse
import dataclasses
import os
import tempfile
import warnings

_MULTI_DEVICE = ("multi-device training is not ported yet (ROADMAP.md "
                 "section A, item 8b); this launcher trains on one device")


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
                   help="devices to train on: 0 or 1 (one device)")
    p.add_argument("--mesh", default="auto",
                   help="'auto' | '1x1' (one device)")
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
    if args.devices not in (0, 1) or args.mesh not in ("auto", "1x1"):
        raise NotImplementedError(
            f"--devices {args.devices} --mesh {args.mesh}: {_MULTI_DEVICE}")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.config import Backend, DaismConfig, Variant
    from repro_torch.data import lm_batches
    from repro_torch.launch.steps import build_artifacts
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.fault_tolerance import TrainLoopConfig, run

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

    art = build_artifacts(cfg, device=args.device,
                          opt_cfg=AdamWConfig(lr=args.lr),
                          total_steps=args.steps,
                          warmup=max(args.steps // 20, 1))
    dev = art.model.device
    print(f"device: {dev} ({cfg.n_layers} layers, d_model {cfg.d_model}); "
          "mesh: {'data': 1, 'model': 1}")
    params = art.init_params(0)
    opt = art.init_opt(params)
    gen = lm_batches(cfg.vocab, args.batch, args.seq, seed=0)
    next(gen)  # the reference draws one batch to lay out its sharding

    def put(b):
        return {k: torch.from_numpy(v).to(dev).long() for k, v in b.items()}

    def log(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}", flush=True)

    loop = TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                           ckpt_every=args.ckpt_every,
                           log_every=args.log_every)
    params, opt, state = run(loop, art.train_step, params, opt, gen, put,
                             metrics_hook=log)
    print(f"done at step {state.step}; stragglers seen: {state.stragglers}")
    if args.policy or args.daism != "exact":
        from repro_torch.policy import site_report

        print(site_report(cfg.approx_policy))
    return params, opt, state


if __name__ == "__main__":
    main()
