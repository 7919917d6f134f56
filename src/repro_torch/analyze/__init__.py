"""daism-lint: static analysis of (model, policy, engine) triples.

The analyzer runs a registered model config's forward under an
``ApproxPolicy`` on torch's ``meta`` device — no weights allocated, no
kernels launched — materializes the complete op-site graph, and runs
pluggable checkers over it (policy reachability, backend legality, the
CUDA kernels' tiling, per-segment and per-config costs, serving config).
See ``launch/lint.py`` for the CLI and ``analyze/checkers.py`` for the
lint-code table; both follow the JAX package's ``repro.analyze``.

Quick start::

    from repro_torch.analyze import analyze, format_text

    report = analyze("tinyllama_1_1b", "*/attn/*=exact,*=pc3_tr")
    print(format_text(report))
    raise SystemExit(report.exit_code)
"""
from __future__ import annotations

from typing import Optional

from .checkers import (CATEGORIES, SMEM_BUDGET_KIB, Finding, check_attention,
                       check_backend, check_energy, check_policy,
                       check_recompile, check_serving, check_tiling,
                       engine_config_finding, run_checkers)
from .report import AnalysisReport, format_json, format_text
from .sitegraph import SiteGraph, SiteRecord, trace_site_graph

__all__ = [
    "analyze", "preflight", "AnalysisReport", "Finding",
    "SiteGraph", "SiteRecord", "trace_site_graph", "run_checkers",
    "check_policy", "check_backend", "check_tiling", "check_attention",
    "check_recompile", "check_energy", "check_serving",
    "engine_config_finding",
    "format_text", "format_json", "CATEGORIES",
]


def analyze(cfg, policy=None, *, engine_cfg=None, serving: bool = True,
            advisory_serving: bool = False, batch: int = 1, seq: int = 8,
            device: str = "cuda", smem_budget_kib: float = SMEM_BUDGET_KIB,
            max_segments: int = 4, max_kernel_variants: int = 8,
            engine_error: Optional[Exception] = None) -> AnalysisReport:
    """Lint ``cfg`` (an ArchConfig or a registered arch name) under
    ``policy`` (None = the config's own, a spec string, or an ApproxPolicy).

    ``engine_cfg`` focuses the serving checks on a concrete deployment;
    without one they run against the default ``EngineConfig``.
    ``advisory_serving`` caps serving findings at warning severity (the
    sweep mode, where no deployment is actually being launched).
    ``device`` is the target the triple will run on (``cuda`` or ``cpu``),
    not this host: linting for ``cuda`` needs no card. ``engine_error``, an
    ``EngineConfig`` that failed to construct, is reported as SRV000 in
    place of the serving checks.
    """
    if isinstance(cfg, str):
        from repro_torch.configs import get_config
        cfg = get_config(cfg)
    graph = trace_site_graph(cfg, policy, batch=batch, seq=seq)
    findings, categories = run_checkers(
        graph, engine_cfg, serving=serving and engine_error is None,
        advisory_serving=advisory_serving, device=device,
        smem_budget_kib=smem_budget_kib, max_segments=max_segments,
        max_kernel_variants=max_kernel_variants)
    if engine_error is not None:
        findings.insert(0, engine_config_finding(engine_error))
        categories = (*categories, "serving")
    return AnalysisReport(graph=graph, findings=findings,
                          categories=categories)


def preflight(cfg, policy=None, *, engine_cfg=None, serving: bool = True,
              device: str = "cuda", label: str = "preflight",
              strict: bool = True,
              engine_error: Optional[Exception] = None
              ) -> Optional[AnalysisReport]:
    """Launcher hook: lint before committing to weights on the device.

    Prints findings (site table omitted), raises ``SystemExit`` on
    error-severity findings when ``strict``. Returns the report.
    """
    report = analyze(cfg, policy, engine_cfg=engine_cfg, serving=serving,
                     device=device, engine_error=engine_error)
    visible = [f for f in report.findings if f.severity != "info"]
    if visible:
        print(f"-- {label}: daism-lint --")
        for f in visible:
            print(f"  {f}")
    if strict and report.errors:
        found = ", ".join(sorted({f.code for f in report.errors}))
        raise SystemExit(
            f"{label}: daism-lint found {len(report.errors)} error(s) "
            f"({found}) — fix the policy/engine config or pass "
            "--no-preflight")
    return report
