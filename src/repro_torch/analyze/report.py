"""Analysis report container + text/json rendering for daism-lint."""
from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple

from repro_torch.policy import describe_config

from .checkers import Finding
from .sitegraph import SiteGraph

_ICON = {"error": "E", "warning": "W", "info": "I"}


@dataclasses.dataclass
class AnalysisReport:
    """Everything one lint run produced: the graph and the findings."""

    graph: SiteGraph
    findings: List[Finding]
    categories: Tuple[str, ...]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def exit_code(self) -> int:
        return 1 if self.errors else 0

    def counts(self) -> dict:
        by_cat = {c: 0 for c in self.categories}
        for f in self.findings:
            if f.severity != "info":
                by_cat[f.category] = by_cat.get(f.category, 0) + 1
        return by_cat


def _site_table(graph: SiteGraph) -> List[str]:
    if not graph.sites:
        return ["  (no contraction sites traced)"]
    width = max(len(s.path) for s in graph.sites)
    lines = []
    for s in graph.sites:
        m, k, n = s.dims
        rep = f" x{s.repeat}" if s.repeat > 1 else ""
        lines.append(
            f"  {s.path:<{width}}  {s.kind.value:<10s} "
            f"{describe_config(s.config):<18s} {s.dtype:<9s} "
            f"({m}x{k}x{n}){rep:<5s} {s.macs:>14,d} MACs "
            f"{s.energy_pj / 1e6:>9.3f} uJ")
    return lines


def format_text(report: AnalysisReport, *, sites: bool = True) -> str:
    graph = report.graph
    used, exact = graph.energy_uj()
    head = (f"== daism-lint: {graph.cfg.name} under policy "
            f"{graph.policy.name or '<anonymous>'} ==")
    lines = [head]
    if sites:
        lines += _site_table(graph)
    for stack, segs in graph.segments.items():
        lines.append(f"  {stack}: {len(segs)} scan segment(s) "
                     + " ".join(f"[{lo},{hi})" for lo, hi in segs))
    lines.append("")
    for f in report.findings:
        where = f"  [{f.site}]" if f.site else ""
        lines.append(f"{_ICON[f.severity]} {f.code} ({f.category}) "
                     f"{f.message}{where}")
    n_err, n_warn = len(report.errors), len(report.warnings)
    checked = ", ".join(
        f"{c}:{'FAIL' if any(x.category == c and x.severity == 'error' for x in report.findings) else 'ok'}"
        for c in report.categories)
    lines.append(f"{len(report.categories)} checkers [{checked}] — "
                 f"{n_err} error(s), {n_warn} warning(s); estimated energy "
                 f"{used:.2f}/{exact:.2f} uJ (policy/exact)")
    return "\n".join(lines)


def format_json(report: AnalysisReport) -> str:
    graph = report.graph
    used, exact = graph.energy_uj()
    payload = {
        "model": graph.cfg.name,
        "policy": graph.policy.name or "<anonymous>",
        "categories": list(report.categories),
        "exit_code": report.exit_code,
        "energy_uj": {"policy": used, "exact": exact},
        "segments": {k: [list(s) for s in v]
                     for k, v in graph.segments.items()},
        "sites": [
            {"path": s.path, "kind": s.kind.value,
             "config": describe_config(s.config), "dtype": s.dtype,
             "dims": list(s.dims), "macs": s.macs, "repeat": s.repeat,
             "energy_uj": s.energy_pj / 1e6}
            for s in graph.sites],
        "findings": [
            {"code": f.code, "severity": f.severity, "category": f.category,
             "message": f.message, "site": f.site}
            for f in report.findings],
    }
    return json.dumps(payload, indent=2)
