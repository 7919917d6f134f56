"""Pluggable checkers over a :class:`~repro_torch.analyze.sitegraph.SiteGraph`.

Each checker is a pure function ``SiteGraph -> [Finding]``. The codes,
severities, categories and ``site`` anchors are the JAX package's
(``repro/analyze/checkers.py``), so one policy and one set of engine flags
give the same findings in both packages, except the TIL family: it
describes the tiles of the CUDA kernels this package launches
(``csrc/daism_matmul.cu``, ``csrc/flash_attention.cu``), with every number
read from the kernel modules.

=======  ========  ====================================================
code     severity  meaning
=======  ========  ====================================================
POL001   error     policy rule matches zero op-sites
POL002   warning   rule fully shadowed by earlier rules
POL003   warning   catch-all rule ordered before more-specific rules
POL004   warning   deprecated ``ArchConfig.daism`` uniform shim in use
BCK001   error     backend illegal for the site's operand dtype
TIL001   warning   GEMM dims off the kernel path's tile (padded work)
TIL002   warning   GEMM block's shared memory exceeds the budget
TIL003   info      kernel sites take the plain version on a CPU target
TIL004   warning   flash-attention tiles pad the sequence / head dim
TIL005   error     flash-attention site the kernel refuses (a DAISM
                   variant on a non-bf16 model, a head dim past 256)
RCP001   warning   policy shatters a layer stack into many segments
RCP002   warning   dispatcher cache would hold many kernel variants
ENE001   info      estimated multiply-energy summary
SRV000   error     EngineConfig rejected at construction
SRV001   error*    model ``window`` incompatible with the paged cache
SRV002   error*    KV pool cannot hold one max-length request
SRV003   warning   KV pool oversubscribed vs expected concurrency
SRV004   warning   two tiers resolve to the same policy group
SRV005   error*    tier policy spec invalid for this model
SRV006   info      model has no paged decode path; serving checks skipped
SRV007   error*    KV pages / decode rows not divisible by mesh shards
SRV008   warning   swap buffer smaller than one max-length request
SRV009   error*    speculative draft policy incompatible with the target
=======  ========  ====================================================

``error*`` codes downgrade to warnings in *advisory* mode (the ``--all``
sweep, where no serving deployment is actually requested).
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.config import Backend
from repro_torch.policy import (OpKind, describe_config, parse_policy,
                                validate_for_dtype)

from .sitegraph import SiteGraph

SEVERITIES = ("error", "warning", "info")
CATEGORIES = ("policy", "backend", "tiling", "recompile", "energy", "serving")
# the H100's shared memory a block may opt into (227 KiB)
SMEM_BUDGET_KIB = 227.0
TARGETS = ("cuda", "cpu")
# the sites whose approximate ':pallas' numerics run the DAISM GEMM kernel
GEMM_KINDS = (OpKind.DENSE, OpKind.CONV, OpKind.MOE_EXPERT, OpKind.LM_HEAD)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnostic, anchored to a site/rule where possible."""

    code: str
    severity: str      # error | warning | info
    category: str      # see CATEGORIES
    message: str
    site: str = ""     # site path or rule/tier anchor ("" = whole config)

    def __str__(self) -> str:
        where = f" [{self.site}]" if self.site else ""
        return f"{self.code} {self.severity}: {self.message}{where}"


def check_policy(graph: SiteGraph) -> List[Finding]:
    """Rule reachability: zero-match, shadowing, catch-all ordering, and the
    deprecated ``daism`` shim."""
    findings = []
    policy = graph.policy
    site_keys = [(s.path, s.kind) for s in graph.sites]
    n_rules = len(policy.rules)
    matched = [set() for _ in range(n_rules)]  # sites the pattern matches
    won = [set() for _ in range(n_rules)]      # sites the rule resolves
    for path, kind in site_keys:
        winner = None
        for i, rule in enumerate(policy.rules):
            if rule.matches(path, kind):
                matched[i].add((path, kind))
                if winner is None:
                    winner = i
        if winner is not None:
            won[winner].add((path, kind))
    for i, rule in enumerate(policy.rules):
        anchor = f"rule {i}: {rule.pattern}"
        if not matched[i]:
            findings.append(Finding(
                "POL001", "error", "policy",
                f"rule {i} ({rule.pattern}={describe_config(rule.config)}) "
                f"matches none of the model's {len(site_keys)} op-sites — "
                "it silently does nothing; fix the glob or delete the rule",
                site=anchor))
        elif not won[i]:
            shadows = sorted({j for j in range(i)
                              for s in matched[i] if s in matched[j]})
            by = ", ".join(f"rule {j} ({policy.rules[j].pattern})"
                           for j in shadows[:3])
            findings.append(Finding(
                "POL002", "warning", "policy",
                f"rule {i} ({rule.pattern}={describe_config(rule.config)}) "
                f"is fully shadowed by {by}: every site it matches is "
                "claimed earlier (first match wins); reorder or remove it",
                site=anchor))
        if matched[i] and len(matched[i]) == len(site_keys) and i < n_rules - 1:
            findings.append(Finding(
                "POL003", "warning", "policy",
                f"rule {i} ({rule.pattern}) is a catch-all placed before "
                f"{n_rules - 1 - i} more-specific rule(s), which can never "
                "fire; move the catch-all last (or use default=)",
                site=anchor))
    if graph.cfg.policy is None and not graph.cfg.daism.exact:
        findings.append(Finding(
            "POL004", "warning", "policy",
            "config uses the deprecated ArchConfig.daism uniform shim "
            f"(daism={describe_config(graph.cfg.daism)}); set "
            f"policy=parse_policy('*={describe_config(graph.cfg.daism)}') "
            "instead"))
    return findings


def check_backend(graph: SiteGraph) -> List[Finding]:
    """Backend legality per site, ahead of any run: the exact errors
    ``resolve_site`` would raise mid-forward, reported as findings."""
    findings = []
    for s in graph.sites:
        try:
            validate_for_dtype(s.config, s.dtype, site=s.path)
        except ValueError as e:
            findings.append(Finding("BCK001", "error", "backend", str(e),
                                    site=s.path))
    return findings


def _target(device: str) -> str:
    import torch

    target = torch.device(device).type
    if target not in TARGETS:
        raise ValueError(f"lint target device must be one of {TARGETS}, got "
                         f"{device!r}")
    return target


def _kernel_gemm(s) -> bool:
    """The site launches the DAISM GEMM kernel on the card."""
    return (s.kind in GEMM_KINDS and not s.config.exact
            and s.config.backend is Backend.PALLAS)


def _kernel_flash(s) -> bool:
    """The site launches the flash-attention kernel on the card."""
    return s.kind is OpKind.ATTN_QK and s.config.attn_kernel == "flash"


def _padded(ax: str, dim: int, tile: int) -> str:
    return f"{ax}: {dim} -> {-(-dim // tile) * tile}"


def check_tiling(graph: SiteGraph, *, device: str = "cuda",
                 smem_budget_kib: float = SMEM_BUDGET_KIB) -> List[Finding]:
    """DAISM GEMM kernel tiling: padded work on the path ``_plan`` picks at
    the site's dims (TIL001), a block's shared memory against the budget
    (TIL002), and kernel sites on a CPU target (TIL003)."""
    from repro_torch.kernels import daism_matmul as dm

    target = _target(device)
    findings = []
    for s in graph.sites:
        if not _kernel_gemm(s):
            continue
        m, k, n = s.dims
        # expert sites run E products in one launch, which _plan counts
        experts = (max(1, s.macs // (s.repeat * m * k * n))
                   if s.kind is OpKind.MOE_EXPERT and m * k * n else 1)
        plan = dm._plan(m, k, n, s.config.variant, experts=experts)
        if plan is None:
            # csrc/daism_matmul.cu daism_matmul_approx: 64 x 64 output
            # tiles (rows past M idle, columns past N multiply zeros) and K
            # in steps of 16 (a ragged step multiplies zeros)
            path = f"tile path ({dm.BLOCK_M} x {dm.BLOCK_N} tiles)"
            tiles = (("m", m, dm.BLOCK_M), ("n", n, dm.BLOCK_N),
                     ("k", k, dm.BLOCK_K))
        else:
            # daism_matmul_splitk: a block owns SPLIT_K_THREADS * NC
            # columns (threads past N idle) and one K chunk of KC, whose
            # shared fields are zero-filled past K; rows past M are skipped
            rows, cols = plan
            path = (f"split-K path ({rows} rows a block, "
                    f"{dm.SPLIT_K_THREADS * cols} columns, K chunks of "
                    f"{dm.KC})")
            tiles = (("n", n, dm.SPLIT_K_THREADS * cols), ("k", k, dm.KC))
        ragged = [_padded(ax, dim, t) for ax, dim, t in tiles if dim % t]
        if ragged:
            findings.append(Finding(
                "TIL001", "warning", "tiling",
                f"GEMM dims (m={m}, k={k}, n={n}) run on the kernel's "
                f"{path}, which pads {', '.join(ragged)} — idle lanes and "
                "products of zeros",
                site=s.path))
        smem = dm.smem_bytes(plan)
        if smem > smem_budget_kib * 1024:
            findings.append(Finding(
                "TIL002", "warning", "tiling",
                f"a block of the kernel's {path} uses {smem / 1024:.1f} KiB "
                f"of shared memory, over the {smem_budget_kib:g} KiB budget",
                site=s.path))
    if target == "cpu":
        sites = [s.path for s in graph.sites
                 if _kernel_gemm(s) or _kernel_flash(s)]
        if sites:
            findings.append(Finding(
                "TIL003", "info", "tiling",
                f"{len(sites)} kernel site(s) take the plain version on a "
                "cpu target (the CUDA kernels run only on the card) — "
                "orders of magnitude slower; use backend 'jnp' for CPU runs",
                site=sites[0]))
    return findings


def check_attention(graph: SiteGraph) -> List[Finding]:
    """Flash-attention dispatch legality (TIL family, ATTN_QK sites only).

    TIL004: the CUDA kernels tile queries against key tiles of 128 — the
    tensor-core kernel (bf16 exact) 64 queries (64 keys for its head dims
    past 128), its head dim zero-padded to 16-column MMA steps; the integer
    kernel (``flash_fwd_int``) 8, 16 or 32 queries as ``int_plan`` picks
    for the site's B x H heads (its multiply count over one head's), its
    head dim padded to 16, 32, 64, 128, 192 or 256 — ragged sequence
    lengths and head dims are masked or zero but wasted work. TIL005: a
    site the kernel refuses, an approximate variant off bfloat16 (the
    ``resolve_site`` error as a pre-run finding) or a head dim past the
    kernels' largest.
    """
    from repro_torch.kernels import flash_attention as fa

    findings = []
    for s in graph.sites:
        if not _kernel_flash(s):
            continue
        sq, d, skv = s.dims
        variant = None if s.config.exact else s.config.variant
        bh = max(1, s.macs // (s.repeat * 2 * sq * skv * d))
        try:
            bq, bk, dp = fa.kernel_tiles(d, s.dtype, variant, bh=bh, sq=sq)
        except ValueError as e:
            hint = ("run the site exact (keep ':flash', drop the variant) or "
                    "switch the compute dtype" if variant is not None
                    and s.dtype != "bfloat16" else "drop ':flash'")
            findings.append(Finding(
                "TIL005", "error", "tiling",
                f"the flash-attention kernel refuses this site: {e}; {hint}",
                site=s.path))
            continue
        ragged = [_padded(ax, dim, t) for ax, dim, t in
                  (("sq", sq, bq), ("skv", skv, bk)) if dim % t]
        if dp != d:
            ragged.append(f"head_dim: {d} -> {dp}")
        tensor_cores = variant is None and s.dtype == "bfloat16"
        if ragged:
            findings.append(Finding(
                "TIL004", "warning", "tiling",
                f"flash-attention tiles (bq={bq}, bk={bk}"
                + ("" if dp == d else
                   f", head dim in steps of {fa.TC_HEAD_STEP}" if tensor_cores
                   else f", head dim padded to {dp}")
                + f") pad this site: {', '.join(ragged)} — masked or zero "
                "but wasted work on every padded tile",
                site=s.path))
    return findings


def check_recompile(graph: SiteGraph, *, max_segments: int = 4,
                    max_kernel_variants: int = 8) -> List[Finding]:
    """Per-segment and per-config costs: segment shatter and kernel-cache
    pressure (the JAX package's recompile hazards)."""
    findings = []
    for stack, segs in graph.segments.items():
        if len(segs) > max_segments:
            findings.append(Finding(
                "RCP001", "warning", "recompile",
                f"policy splits the layer stack '{stack}' into "
                f"{len(segs)} uniform segments (> {max_segments}): "
                "run_policy_segments runs each as a separate loop and "
                "resolves the policy once per segment, so host work grows "
                "with the rule granularity; coarsen the per-depth rules",
                site=stack))
    variants = {s.config for s in graph.sites if not s.config.exact}
    if len(variants) > max_kernel_variants:
        findings.append(Finding(
            "RCP002", "warning", "recompile",
            f"policy resolves {len(variants)} distinct non-exact "
            f"DaismConfigs (> {max_kernel_variants}): the dispatcher "
            "(policy/dispatch.py matmul_kernel) caches one callable per "
            "distinct config; merge near-identical configs"))
    return findings


def check_energy(graph: SiteGraph) -> List[Finding]:
    """Always-on summary so the energy math is visible in every report."""
    used, exact = graph.energy_uj()
    if exact <= 0:
        return [Finding("ENE001", "info", "energy",
                        "no contraction sites traced; energy model idle")]
    saved = 100.0 * (1.0 - used / exact)
    return [Finding(
        "ENE001", "info", "energy",
        f"estimated multiply energy {used:.2f} uJ vs all-exact "
        f"{exact:.2f} uJ ({saved:+.1f}% saved) over {graph.total_macs():,d} "
        f"MACs / {len(graph.sites)} sites")]


def _sev(advisory: bool) -> str:
    return "warning" if advisory else "error"


def check_serving(graph: SiteGraph, engine_cfg=None, *,
                  advisory: bool = False) -> List[Finding]:
    """Serving-config lints against the traced model (paged engine)."""
    from repro_torch.serve.engine import EngineConfig

    if graph.cfg.family not in ("dense", "moe"):
        return [Finding(
            "SRV006", "info", "serving",
            f"family '{graph.cfg.family}' has no paged decode path; "
            "serving checks skipped")]
    findings = []
    if engine_cfg is None:
        engine_cfg = EngineConfig()
    if graph.cfg.window:
        findings.append(Finding(
            "SRV001", _sev(advisory), "serving",
            f"ArchConfig.window={graph.cfg.window} is incompatible with "
            "the paged KV cache (ring buffers roll in place, pages are "
            "freed whole); serve with window=0 or the slot engine"))

    capacity = engine_cfg.blocks * engine_cfg.block_size
    if capacity < engine_cfg.max_seq:
        findings.append(Finding(
            "SRV002", _sev(advisory), "serving",
            f"KV pool holds {capacity} tokens ({engine_cfg.blocks} pages x "
            f"{engine_cfg.block_size}) < max_seq={engine_cfg.max_seq}: a "
            "max-length request can never be admitted; add pages or lower "
            "max_seq"))
    groups = max(1, len(engine_cfg.tiers))
    demand = engine_cfg.num_slots * groups * engine_cfg.max_seq
    if capacity < demand and capacity >= engine_cfg.max_seq:
        findings.append(Finding(
            "SRV003", "warning", "serving",
            f"KV pool ({capacity} tokens) covers only "
            f"{capacity / demand:.0%} of peak demand (num_slots="
            f"{engine_cfg.num_slots} x {groups} policy group(s) x max_seq="
            f"{engine_cfg.max_seq} = {demand}): full-width decode at max "
            "length will stall on page allocation"))

    site_keys = [(s.path, s.kind) for s in graph.sites]
    tier_groups = {}
    for name, spec in engine_cfg.tiers:
        try:
            pol = parse_policy(spec, name=name)
        except ValueError as e:
            findings.append(Finding(
                "SRV005", _sev(advisory), "serving",
                f"tier '{name}' policy spec rejected: {e}", site=name))
            continue
        key = dataclasses.replace(pol, name="")
        tier_groups.setdefault(key, []).append(name)
        for i, rule in enumerate(pol.rules):
            if not any(rule.matches(p, k) for p, k in site_keys):
                findings.append(Finding(
                    "SRV005", "warning", "serving",
                    f"tier '{name}' rule {i} ({rule.pattern}) matches no "
                    f"op-site of {graph.cfg.name}; the tier silently "
                    "degrades to its remaining rules", site=name))
        for where, dcfg in [(f"tier '{name}' rule {i} ({r.pattern})", r.config)
                            for i, r in enumerate(pol.rules)] + [
                                (f"tier '{name}' default", pol.default)]:
            try:
                validate_for_dtype(dcfg, graph.cfg.compute_dtype, site=where)
            except ValueError as e:
                findings.append(Finding("SRV005", _sev(advisory), "serving",
                                        str(e), site=name))
    for names in tier_groups.values():
        if len(names) > 1:
            findings.append(Finding(
                "SRV004", "warning", "serving",
                f"tiers {names} resolve to the same policy group — they "
                "share one step and one decode batch; merge them or "
                "differentiate the specs", site=names[0]))
    if engine_cfg.shards > 1 and (engine_cfg.blocks % engine_cfg.shards
                                  or engine_cfg.num_slots % engine_cfg.shards):
        findings.append(Finding(
            "SRV007", _sev(advisory), "serving",
            f"blocks={engine_cfg.blocks} / num_slots={engine_cfg.num_slots} "
            f"not divisible by the mesh serving-axis size "
            f"({engine_cfg.shards} shards): the Sharder's divisibility "
            "fallback silently replicates the KV pool and decode batch "
            "instead of sharding them — size both as multiples of shards"))
    if (engine_cfg.preempt and engine_cfg.swap_blocks
            and engine_cfg.swap_blocks < engine_cfg.max_blocks_per_seq):
        findings.append(Finding(
            "SRV008", "warning", "serving",
            f"preemption enabled with swap_blocks={engine_cfg.swap_blocks} "
            f"< one max-length request ({engine_cfg.max_blocks_per_seq} "
            "pages): a long-running victim cannot be swapped out, so "
            "exhaustion degrades to stalls; raise swap_blocks or leave it "
            "0 (auto: one full request)"))
    if getattr(engine_cfg, "spec_k", 0):
        findings += _check_spec_draft(graph, engine_cfg, advisory=advisory)
    return findings


def _check_spec_draft(graph: SiteGraph, engine_cfg, *,
                      advisory: bool = False) -> List[Finding]:
    """SRV009: the self-speculative draft policy must be compatible with
    the verify target. Three ways it can fail:

    * a windowed model — draft steps write K/V ``spec_k`` positions ahead
      of the committed length, and a rolling ring buffer can wrap those
      writes onto live history before verify overwrites them;
    * the draft tier is illegal for the model's compute dtype (LUT backend
      or flash-attention DAISM variants off bf16) — the draft step would
      raise at the first speculative step, long after launch;
    * the draft policy is not actually cheaper than the target under the
      analyzer's energy model — speculation then burns more multiply
      energy per accepted token than plain decode, silently.
    """
    from repro_torch.policy import effective_attn_config, energy_per_mult_pj

    findings = []
    spec = dict(engine_cfg.tiers).get(engine_cfg.spec_draft,
                                      engine_cfg.spec_draft)
    try:
        draft = parse_policy(spec, name="spec-draft")
    except ValueError as e:
        return [Finding(
            "SRV009", _sev(advisory), "serving",
            f"speculative draft spec '{engine_cfg.spec_draft}' rejected: "
            f"{e}", site="spec_draft")]
    if graph.cfg.window:
        findings.append(Finding(
            "SRV009", _sev(advisory), "serving",
            f"speculative decoding (spec_k={engine_cfg.spec_k}) on a "
            f"windowed model (window={graph.cfg.window}): draft steps "
            "write K/V ahead of the committed length and a rolling window "
            "can wrap those writes onto live history; serve with window=0",
            site="spec_draft"))
    for where, dcfg in [(f"draft rule {i} ({r.pattern})", r.config)
                        for i, r in enumerate(draft.rules)] + [
                            ("draft default", draft.default)]:
        try:
            validate_for_dtype(dcfg, graph.cfg.compute_dtype, site=where)
        except ValueError as e:
            findings.append(Finding(
                "SRV009", _sev(advisory), "serving",
                f"speculative {e}", site="spec_draft"))

    def _policy_uj(pol) -> float:
        total = 0.0
        for s in graph.sites:
            resolved = pol.resolve(s.path, s.kind)
            if s.kind is OpKind.ATTN_QK:
                resolved = effective_attn_config(resolved)
            total += s.macs * energy_per_mult_pj(resolved, s.dtype)
        return total * 1e-6

    draft_uj = _policy_uj(draft)
    draft_key = dataclasses.replace(draft, name="")
    target_uj, _ = graph.energy_uj()
    # sums accumulate in different orders; 1e-9 relative slack keeps
    # "equal energy" (draft == target policy) on the error side
    if target_uj > 0 and draft_uj >= target_uj * (1 - 1e-9):
        findings.append(Finding(
            "SRV009", _sev(advisory), "serving",
            f"speculative draft policy is not cheaper than the target "
            f"({draft_uj:.2f} uJ vs {target_uj:.2f} uJ per forward under "
            "the energy model): every rejected draft token costs more "
            "than the exact decode it replaces; pick a cheaper draft "
            "tier or disable speculation", site="spec_draft"))
    for name, tier_spec in engine_cfg.tiers:
        try:
            pol = parse_policy(tier_spec, name=name)
        except ValueError:
            continue  # already reported as SRV005
        if dataclasses.replace(pol, name="") == draft_key:
            continue  # engine disables speculation for the draft's own group
        tier_uj = _policy_uj(pol)
        if tier_uj > 0 and draft_uj >= tier_uj * (1 - 1e-9):
            findings.append(Finding(
                "SRV009", "warning", "serving",
                f"speculative draft is not cheaper than tier '{name}' "
                f"({draft_uj:.2f} uJ vs {tier_uj:.2f} uJ): that group's "
                "draft steps cost at least as much as the decode steps "
                "they try to skip", site="spec_draft"))
    return findings


def run_checkers(graph: SiteGraph, engine_cfg=None, *,
                 serving: bool = True, advisory_serving: bool = False,
                 device: str = "cuda",
                 smem_budget_kib: float = SMEM_BUDGET_KIB,
                 max_segments: int = 4, max_kernel_variants: int = 8
                 ) -> "tuple[List[Finding], tuple]":
    """Run every checker; returns (findings, categories_checked)."""
    findings = []
    findings += check_policy(graph)
    findings += check_backend(graph)
    findings += check_tiling(graph, device=device,
                             smem_budget_kib=smem_budget_kib)
    findings += check_attention(graph)
    findings += check_recompile(graph, max_segments=max_segments,
                                max_kernel_variants=max_kernel_variants)
    findings += check_energy(graph)
    categories = ["policy", "backend", "tiling", "recompile", "energy"]
    if serving:
        findings += check_serving(graph, engine_cfg,
                                  advisory=advisory_serving)
        categories.append("serving")
    order = {s: i for i, s in enumerate(SEVERITIES)}
    findings.sort(key=lambda f: (order[f.severity], f.category, f.code))
    return findings, tuple(categories)


def engine_config_finding(err: Exception) -> Finding:
    """Wrap an EngineConfig construction error as a finding (SRV000)."""
    return Finding("SRV000", "error", "serving", str(err))
