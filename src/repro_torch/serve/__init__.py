"""Serving: continuous batching over a paged (block-table) KV cache with
per-request approximation-policy tiers — see engine.py and kv_pool.py."""
from .engine import EngineConfig, ServeEngine, ServeReport, parse_tiers
from .kv_pool import BlockPool, blocks_needed
from .scheduler import Request, RequestState, Scheduler
from .workload import poisson_requests, synthetic_requests

__all__ = ["BlockPool", "EngineConfig", "Request", "RequestState",
           "Scheduler", "ServeEngine", "ServeReport", "blocks_needed",
           "parse_tiers", "poisson_requests", "synthetic_requests"]
