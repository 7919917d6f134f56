"""daism-lint CLI: static preflight for (model, policy, engine) triples.

    PYTHONPATH=src python -m repro_torch.launch.lint \
        --model tinyllama_1_1b --policy "*/attn/*=exact,*=pc3_tr"

Runs the model's forward under the policy on torch's ``meta`` device (no
weights allocated, no kernels launched), prints the op-site table, and runs
the full checker suite — policy reachability, backend legality, the CUDA
kernels' tiling, per-segment and per-config costs, energy summary, serving
config. ``--device`` is the target the triple will run on (``cuda``, the
default, or ``cpu``); linting for the card needs no card. Exits 1 on any
error-severity finding, so it gates the train/serve launchers.

``--all`` lints every registered config; serving findings are advisory
there since no deployment is being launched. The flags are the JAX
package's ``repro.launch.lint``, plus ``--device``.
"""
import argparse
import sys


def _engine_cfg(args):
    """Build the EngineConfig under lint (raises ValueError when the flags
    do not make one)."""
    from repro_torch.serve.engine import EngineConfig, parse_tiers

    tiers = parse_tiers(args.tiers) if args.tiers else ()
    return EngineConfig(num_slots=args.slots, max_seq=args.max_seq,
                        block_size=args.block_size, num_blocks=args.blocks,
                        prefill_chunk=args.prefill_chunk, tiers=tiers,
                        shards=args.shards, preempt=args.preempt,
                        swap_blocks=args.swap_blocks,
                        spec_draft=args.spec_draft, spec_k=args.spec_k)


def _lint_one(name, args, *, advisory):
    from repro_torch.analyze import analyze

    engine_cfg = engine_error = None
    try:
        engine_cfg = _engine_cfg(args)
    except ValueError as e:
        # the engine config itself is broken: still trace + run the other
        # checkers, with the construction error as an SRV000 finding
        engine_error = e
    return analyze(name, args.policy or None, engine_cfg=engine_cfg,
                   advisory_serving=advisory, seq=args.seq,
                   device=args.device, engine_error=engine_error)


def main(argv=None):
    p = argparse.ArgumentParser(prog="daism-lint", description=__doc__)
    p.add_argument("--model", "--arch", dest="model", default="",
                   help="registered config name (see repro_torch.configs)")
    p.add_argument("--all", action="store_true",
                   help="lint every registered config (serving advisory)")
    p.add_argument("--policy", default="",
                   help="candidate policy spec, e.g. '*/attn/*=exact,"
                        "*=pc3_tr' (default: the config's own policy)")
    p.add_argument("--tiers", default="",
                   help="serving tier specs 'name=spec;...' to lint against "
                        "the model (repro_torch.serve.parse_tiers form)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--no-sites", action="store_true",
                   help="omit the per-site table from text output")
    p.add_argument("--seq", type=int, default=8,
                   help="abstract trace sequence length")
    p.add_argument("--device", default="cuda",
                   help="target the triple runs on (cuda | cpu); TIL003 "
                        "flags kernel sites on a cpu target")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--blocks", type=int, default=0)
    p.add_argument("--prefill-chunk", type=int, default=16)
    p.add_argument("--shards", type=int, default=1,
                   help="mesh serving-axis size the engine is laid out for "
                        "(the port's engine takes 1)")
    p.add_argument("--preempt", action="store_true",
                   help="lint with preemption/swap admission enabled")
    p.add_argument("--swap-blocks", type=int, default=0,
                   help="host swap buffer pages (0 = one full request)")
    p.add_argument("--spec-draft", default="",
                   help="speculative draft policy: a --tiers name or a raw "
                        "spec (lints compatibility with the model, SRV009)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens per speculative verify step")
    args = p.parse_args(argv)
    if bool(args.model) == args.all:
        p.error("exactly one of --model or --all is required")

    from repro_torch.analyze import format_json, format_text
    from repro_torch.configs import ARCH_IDS, PAPER_IDS

    names = (ARCH_IDS + PAPER_IDS) if args.all else (args.model,)
    worst = 0
    for name in names:
        report = _lint_one(name, args, advisory=args.all)
        if args.format == "json":
            print(format_json(report))
        else:
            print(format_text(report, sites=not (args.no_sites or args.all)))
        worst = max(worst, report.exit_code)
    if args.all:
        print(f"daism-lint: {len(names)} configs linted, "
              f"{'FAIL' if worst else 'ok'}")
    return sys.exit(worst) if worst else 0


if __name__ == "__main__":
    main()
