"""Per-site approximation policies for DAISM numerics.

Models name each contraction they perform (an *op-site*, e.g.
``decoder/layer_3/attn/wq``) and resolve its numerics through an injectable
:class:`ApproxPolicy`: an ordered list of glob rules mapping sites to
:class:`~repro_torch.core.config.DaismConfig` values. The spec language and
the resolution rules are those of the JAX package's ``repro.policy``.
"""
from __future__ import annotations

from .dispatch import (SiteEvent, attention_kernel, clear_log,
                       effective_attn_config, energy_per_mult_pj,
                       estimated_energy_uj, kernel_stats, make_dot,
                       matmul_kernel, observe_sites, policy_conv2d,
                       policy_dot, policy_expert_matmul, resolution_log,
                       resolve_site, site_report, validate_for_dtype)
from .policy import (EXACT, ApproxPolicy, Rule, describe_config,
                     layer_signature, parse_config, parse_policy,
                     plan_segments)
from .sites import OpKind, current_path, current_prefix, site_scope

__all__ = [
    "ApproxPolicy", "Rule", "OpKind", "EXACT",
    "parse_policy", "parse_config", "describe_config",
    "site_scope", "current_path", "current_prefix",
    "make_dot", "policy_dot", "policy_conv2d", "policy_expert_matmul",
    "resolve_site",
    "validate_for_dtype", "observe_sites", "SiteEvent", "energy_per_mult_pj",
    "site_report", "resolution_log", "estimated_energy_uj",
    "kernel_stats", "clear_log", "matmul_kernel",
    "attention_kernel", "effective_attn_config",
    "plan_segments", "layer_signature",
]
