"""Serving launcher: thin CLI over the paged continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b

Builds the model at its published width on the card (``--device cuda``, the
default) with random weights from ``--seed``, submits a synthetic workload
(fixed stagger or Poisson arrivals) and drives
``repro_torch.serve.ServeEngine``. Prints the per-request timeline and the
engine's latency / throughput / KV-utilization report. ``--smoke`` serves
the reduced smoke config (small enough for the CPU with ``--device cpu``);
``--layers N`` cuts the depth and never the width.

The flags are the JAX launcher's (``repro.launch.serve``): ``--preempt``
(with ``--blocks`` to bound the pool) swaps requests out under page
exhaustion, ``--spec-draft``/``--spec-k`` decode speculatively with a
cheap draft policy, and after a run under an approximate policy the
per-group site resolution and energy report is printed. ``--shards`` is
accepted and refused by the engine until tensor-parallel serving is
ported.

Before any weight is built, the daism-lint preflight
(``repro_torch.analyze.preflight``, as ``python -m repro_torch.launch.lint``
runs it) checks the (model, policy, engine) triple for the target
``--device`` and aborts on an error finding: a rule that matches nothing,
a tier illegal for the dtype, a KV pool smaller than one request, an
``EngineConfig`` that does not construct, ``--shards`` above 1.
``--no-preflight`` skips it.
"""
import argparse
import dataclasses
import warnings


def build_daism(variant: str, backend: str):
    from repro_torch.core import Backend, DaismConfig, Variant
    return DaismConfig(variant=Variant(variant), backend=Backend(backend))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true",
                   help="reduced config + small workload (CPU-friendly)")
    p.add_argument("--device", default="cuda",
                   help="where the model and the KV pool live (cuda | cpu)")
    p.add_argument("--layers", type=int, default=0,
                   help="depth override (0 = the config's); width is kept")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--slots", type=int, default=2,
                   help="decode batch width per policy group")
    p.add_argument("--max-seq", type=int, default=64,
                   help="per-request KV capacity (prompt + generation)")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV page size in tokens")
    p.add_argument("--blocks", type=int, default=0,
                   help="physical KV pages (0 = slots*max_seq/block_size)")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="prompt tokens ingested per engine tick "
                        "(chunked prefill; power of two)")
    p.add_argument("--prompt-len", type=int, default=8,
                   help="base prompt length (workload staggers around it)")
    p.add_argument("--gen", type=int, default=8,
                   help="base generation length")
    p.add_argument("--arrival-every", type=int, default=0,
                   help="space arrivals N engine steps apart (0 = all at once)")
    p.add_argument("--poisson", type=float, default=0.0,
                   help="Poisson arrival rate in requests/step (overrides "
                        "--arrival-every; 0 = disabled)")
    p.add_argument("--policy", default="",
                   help="engine-wide per-site approximation policy spec, "
                        "e.g. '*/attn/*=exact,*=pc3_tr:pallas'")
    p.add_argument("--tiers", default="",
                   help="named per-request policy tiers, e.g. "
                        "'free=*=pc3_tr:pallas;paid=*/attn/*=exact,"
                        "*=pc3_tr:pallas' — the workload is spread across "
                        "them")
    p.add_argument("--variant", default="exact",
                   help="DEPRECATED (use --policy): uniform multiplier "
                        "variant (exact | fla | ... | pc3_tr)")
    p.add_argument("--backend", default="jnp",
                   help="daism backend for approximate variants")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shards", type=int, default=1,
                   help="tensor-parallel serving (not ported yet)")
    p.add_argument("--preempt", action="store_true",
                   help="optimistic admission + preemption: swap the "
                        "lowest-priority running request's KV pages to a "
                        "host buffer under pool exhaustion instead of "
                        "reserving whole lifetimes up front")
    p.add_argument("--swap-blocks", type=int, default=0,
                   help="host swap buffer size in KV pages "
                        "(0 = one full request's worth)")
    p.add_argument("--spec-draft", default="",
                   help="self-speculative decoding: draft policy (a --tiers "
                        "name or a raw policy spec) used for cheap draft "
                        "steps; the group's own step verifies them "
                        "(greedy outputs stay token-identical)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="draft tokens proposed per speculative verify step "
                        "(0 = speculation off; pair with --spec-draft)")
    p.add_argument("--sync", action="store_true",
                   help="synchronous tick loop (disable the async "
                        "host/device overlap)")
    p.add_argument("--no-preflight", action="store_true",
                   help="skip the daism-lint static preflight")
    args = p.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import (EngineConfig, ServeEngine, parse_tiers,
                                   poisson_requests, synthetic_requests)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke(window=0)  # paged pools need non-ring caches
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.policy:
        cfg = cfg.with_policy(args.policy)
    elif args.variant != "exact":
        warnings.warn("--variant/--backend are deprecated; use --policy "
                      f"'*={args.variant}:{args.backend}'", DeprecationWarning,
                      stacklevel=1)
        cfg = dataclasses.replace(cfg,
                                  daism=build_daism(args.variant, args.backend))
    tiers = parse_tiers(args.tiers) if args.tiers else ()
    engine_cfg = engine_error = None
    try:
        engine_cfg = EngineConfig(
            num_slots=args.slots, max_seq=args.max_seq,
            block_size=args.block_size, num_blocks=args.blocks,
            prefill_chunk=args.prefill_chunk, tiers=tiers,
            shards=args.shards, preempt=args.preempt,
            swap_blocks=args.swap_blocks, overlap=not args.sync,
            spec_draft=args.spec_draft, spec_k=args.spec_k)
    except ValueError as e:
        if args.no_preflight:
            raise
        engine_error = e  # reported as SRV000 by the preflight
    if not args.no_preflight:
        # static lint of the full (model, policy, engine) triple before the
        # weights exist on the device: bad rules and tiers, undersized
        # pools and what the engine refuses abort here
        from repro_torch.analyze import preflight

        preflight(cfg, engine_cfg=engine_cfg, engine_error=engine_error,
                  device=args.device, label=f"serve {args.arch}")
    model = build_model(cfg, device=args.device)
    with torch.inference_mode():
        params = model.init(args.seed)
    engine = ServeEngine(model, params, engine_cfg, device=args.device)
    tier_names = [name for name, _ in tiers]
    if args.poisson > 0:
        requests = poisson_requests(
            args.requests, cfg.vocab, rate=args.poisson,
            base_prompt=args.prompt_len, base_gen=args.gen, seed=args.seed,
            tiers=tier_names)
    else:
        requests = synthetic_requests(
            args.requests, cfg.vocab, base_prompt=args.prompt_len,
            base_gen=args.gen, seed=args.seed,
            arrival_every=args.arrival_every, tiers=tier_names)
    report = engine.run(requests)

    numerics = (f"tiers {args.tiers}" if args.tiers
                else f"policy {args.policy}" if args.policy else args.variant)
    arrivals = (f"poisson rate {args.poisson}" if args.poisson > 0
                else f"every {args.arrival_every}" if args.arrival_every
                else "all at once")
    print(f"== {args.arch} on {engine.device} ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}; {numerics}) — {args.requests} requests, "
          f"{args.slots} rows/group, {engine.cfg.blocks} x "
          f"{args.block_size}-token KV pages, arrivals {arrivals} ==")
    for ev in report.events:
        if ev["event"] == "admit":
            joined = " (joined running batch)" if ev["joined_running"] else ""
            cached = (f", {ev['cached_blocks']} cached"
                      if ev.get("cached_blocks") else "")
            print(f"step {ev['step']:4d}  admit  req {ev['request_id']} "
                  f"-> {ev['group']}/row {ev['slot']} "
                  f"[{ev['blocks']} pages{cached}]{joined}")
        elif ev["event"] == "preempt":
            print(f"step {ev['step']:4d}  preempt req {ev['request_id']} "
                  f"({ev['group']}/row {ev['slot']}: {ev['blocks']} pages "
                  "swapped to host)")
        elif ev["event"] == "resume":
            print(f"step {ev['step']:4d}  resume req {ev['request_id']} "
                  f"-> {ev['group']}/row {ev['slot']} "
                  f"[{ev['blocks']} pages restored]")
        elif ev["event"] == "spec_off":
            print(f"step {ev['step']:4d}  speculation off for group "
                  f"{ev['group']} (acceptance EWMA {ev['ewma']})")
        else:
            print(f"step {ev['step']:4d}  retire req {ev['request_id']} "
                  f"({ev['group']}/row {ev['slot']} freed, {ev['reason']})")
    print(report.summary())
    if args.tiers or args.policy or args.variant != "exact":
        print(engine.resolution_report())
    if report.completed:
        sample = report.completed[0]
        print(f"sample (req {sample.request_id}): {sample.output}")
    default_workload = all(
        getattr(args, k) == p.get_default(k)
        for k in ("requests", "slots", "gen", "prompt_len", "arrival_every",
                  "poisson", "block_size", "blocks", "prefill_chunk"))
    if args.smoke and default_workload:
        # the gate is calibrated to the default smoke workload (staggered
        # lengths oversubscribing 2 rows)
        if report.joined_mid_stream < 2:  # explicit: survives python -O
            raise SystemExit(
                "smoke workload must exercise continuous batching "
                f"(got {report.joined_mid_stream} mid-stream joins)")
        print("SMOKE-OK: continuous batching exercised "
              f"({report.joined_mid_stream} mid-stream joins)")
    if args.smoke and args.tiers and report.policy_groups < 2:
        raise SystemExit(
            "smoke --tiers workload must exercise >= 2 policy groups "
            f"(got {report.policy_groups})")
    if args.smoke and args.tiers:
        print(f"SMOKE-OK: {report.policy_groups} policy groups served "
              "mixed-tier traffic")
    if args.smoke and args.preempt and args.blocks:
        # an explicitly undersized pool (--blocks) must actually exercise
        # the swap path; auto-sized pools never exhaust
        if not (report.preemptions and report.resumes):
            raise SystemExit(
                "smoke --preempt with a constrained pool must preempt and "
                f"resume (got {report.preemptions} preemption(s), "
                f"{report.resumes} resume(s))")
        if any(s.finish_reason not in ("eos", "length")
               for s in report.completed):
            raise SystemExit("smoke --preempt: a request finished abnormally")
        print(f"SMOKE-OK: {report.preemptions} preemption(s) / "
              f"{report.resumes} resume(s) under page exhaustion")
    if args.smoke and args.spec_k:
        if not report.spec_steps:
            raise SystemExit(
                "smoke --spec-k workload never took a speculative verify "
                "step (draft group ineligible or controller disabled it "
                "before the first step)")
        if report.spec_tokens_per_step < 1.0:
            raise SystemExit(
                "smoke --spec-k: tokens per verify step "
                f"{report.spec_tokens_per_step:.2f} < 1.0 — the bonus-token "
                "guarantee is broken")
        print(f"SMOKE-OK: speculative decoding took {report.spec_steps} "
              f"verify step(s), accept rate {report.spec_accept_rate:.2f}, "
              f"{report.spec_tokens_per_step:.2f} tokens/step")
    return report


if __name__ == "__main__":
    main()
