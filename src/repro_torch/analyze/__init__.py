"""Static analysis of (model, policy) pairs: the op-site graph.

``trace_site_graph`` runs a registered model config's forward on torch's
``meta`` device under an ``ApproxPolicy`` — no weights allocated, no
kernels launched — and returns every contraction site with its resolved
numerics, dims, MAC count and estimated multiply energy. (The JAX package's
checkers, report and ``analyze()`` / ``preflight()`` are not ported yet.)
"""
from __future__ import annotations

from .sitegraph import SiteGraph, SiteRecord, trace_site_graph

__all__ = ["SiteGraph", "SiteRecord", "trace_site_graph"]
