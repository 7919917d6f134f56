"""Abstract op-site graph materialization (no weights, no kernels).

``trace_site_graph`` runs a registered model config's forward pass under an
:class:`~repro_torch.policy.ApproxPolicy` on torch's ``meta`` device, where
tensors carry shapes and dtypes but no storage: every contraction resolves
through the policy dispatcher as usual, and a site observer
(:func:`repro_torch.policy.observe_sites`) captures the full op-site graph —
path, :class:`OpKind`, GEMM dims, operand dtype, resolved
:class:`DaismConfig`, MAC count — without allocating a single weight or
launching a single kernel. (The JAX package traces the same forward with
``jax.eval_shape``; ``repro/analyze/sitegraph.py``.)

The candidate policy may be *invalid* (e.g. a bf16-only backend on an fp32
model): ``ArchConfig`` would reject it at construction, so the trace runs
under a segmentation-preserving rewrite (every distinct config mapped
injectively to a distinct always-legal exact config) and the real policy is
re-resolved per site afterwards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.core.config import Backend, DaismConfig, Variant, torch_dtype
from repro_torch.models.common import ArchConfig
from repro_torch.models.module import unflatten
from repro_torch.policy import (ApproxPolicy, OpKind, effective_attn_config,
                                energy_per_mult_pj, observe_sites,
                                parse_policy)

PolicyLike = Union[None, str, ApproxPolicy]


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One contraction site of the traced model under the analyzed policy."""

    path: str
    kind: OpKind
    config: DaismConfig        # resolved under the *candidate* policy
    dtype: str                 # operand dtype name at the site
    dims: Tuple[int, int, int]  # (m, k, n) of one kernel invocation
    macs: int                  # total multiplies (incl. the segment repeat)
    repeat: int                # ambient segment repeat (layers it covers)

    @property
    def energy_pj(self) -> float:
        return self.macs * energy_per_mult_pj(self.config, self.dtype)

    @property
    def exact_energy_pj(self) -> float:
        exact = DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT)
        return self.macs * energy_per_mult_pj(exact, self.dtype)


@dataclasses.dataclass(frozen=True)
class SiteGraph:
    """The complete op-site graph of one (model config, policy) pair."""

    cfg: ArchConfig
    policy: ApproxPolicy
    sites: Tuple[SiteRecord, ...]
    # layer-stack segmentation, e.g. {"segments": ((0, 22),)}
    segments: Dict[str, Tuple[Tuple[int, int], ...]]

    def energy_uj(self) -> Tuple[float, float]:
        """(policy_energy, all_exact_energy) in uJ over the whole graph."""
        total = sum(s.energy_pj for s in self.sites)
        base = sum(s.exact_energy_pj for s in self.sites)
        return total / 1e6, base / 1e6

    def total_macs(self) -> int:
        return sum(s.macs for s in self.sites)

    def paths(self) -> Tuple[str, ...]:
        return tuple(s.path for s in self.sites)


def _as_policy(cfg: ArchConfig, policy: PolicyLike) -> ApproxPolicy:
    if policy is None:
        return cfg.approx_policy
    if isinstance(policy, str):
        return parse_policy(policy)
    return policy


def _safe_rewrite(policy: ApproxPolicy) -> ApproxPolicy:
    """Segmentation-preserving legality rewrite.

    Maps every distinct config the policy can resolve to onto a distinct
    exact config (disambiguated through ``k_chunk``, which nothing
    validates against the compute dtype). The map is injective, so
    ``plan_segments`` partitions layers identically under the rewrite —
    the traced site paths (``layer_{lo}`` segment labels included) are
    exactly the ones the real policy would produce — while the trace can
    never trip ``validate_for_dtype`` on a deliberately broken candidate.

    ``attn_kernel`` is carried over: segmentation fingerprints collapse
    non-flash ATTN_QK resolutions to one effective EXACT config
    (``policy.layer_signature``), so dropping the flag here would merge
    layer runs the real policy keeps apart. Exact flash configs are legal
    on every dtype, so carrying the flag cannot re-introduce a validation
    crash.
    """
    mapping: Dict[DaismConfig, DaismConfig] = {}

    def safe(c: DaismConfig) -> DaismConfig:
        if c not in mapping:
            mapping[c] = DaismConfig(variant=Variant.EXACT,
                                     backend=Backend.EXACT,
                                     k_chunk=10_000 + len(mapping),
                                     attn_kernel=c.attn_kernel)
        return mapping[c]

    rules = tuple(dataclasses.replace(r, config=safe(r.config))
                  for r in policy.rules)
    return ApproxPolicy(rules=rules, default=safe(policy.default),
                        name=policy.name)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def _input_specs(cfg: ArchConfig, *, batch: int, seq: int):
    """Small ``meta`` inputs covering every ported family's forward."""
    if cfg.family == "cnn":
        side, chan = ((28, 1) if "lenet" in cfg.name else (32, 3))
        return {"images": _meta((batch, side, side, chan), "float32")}
    specs = {"tokens": _meta((batch, seq), "int32")}
    if cfg.family == "vlm":
        specs["image_embeds"] = _meta((batch, cfg.n_image_tokens,
                                       cfg.d_model), cfg.compute_dtype)
    if cfg.family == "audio":
        specs["frames"] = _meta((batch, cfg.enc_frames, cfg.d_model),
                                cfg.compute_dtype)
    return specs


def _collect_segments(model) -> Dict[str, Tuple[Tuple[int, int], ...]]:
    out = {}
    for attr in ("segments", "enc_segments", "dec_segments"):
        segs = getattr(model, attr, None)
        if segs:
            out[attr] = tuple(tuple(s) for s in segs)
    return out


def trace_site_graph(cfg: ArchConfig, policy: PolicyLike = None, *,
                     batch: int = 1, seq: int = 8) -> SiteGraph:
    """Materialize the op-site graph of ``cfg`` under ``policy``.

    Pure shape-level work: parameters are ``meta`` tensors built from the
    model's ``param_specs`` and the forward runs on ``meta`` inputs, so no
    storage is allocated and no kernel launches. ``policy`` may be ``None``
    (the config's own effective policy), a spec string, or an
    ``ApproxPolicy`` — including ones ``ArchConfig`` itself would reject.
    """
    from repro_torch.models.registry import build_model

    candidate = _as_policy(cfg, policy)
    trace_cfg = dataclasses.replace(
        cfg, policy=_safe_rewrite(candidate),
        daism=DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT))
    # the model object only plans segments here; "cpu" allocates nothing
    model = build_model(trace_cfg, device="cpu")
    params = unflatten({path: _meta(shape, dtype) for path, (shape, dtype, _)
                        in model.param_specs().items()})

    events = []
    with observe_sites(events.append), torch.no_grad():
        model.forward(params, _input_specs(cfg, batch=batch, seq=seq))

    seen = {}
    for ev in events:
        # candidate and rewritten policy share rule patterns/order, so
        # re-resolving the candidate picks the same winning rule per site
        resolved = candidate.resolve(ev.path, ev.kind)
        if ev.kind is OpKind.ATTN_QK:
            # the graph records what the site *runs*: attention numerics
            # apply only under ':flash' dispatch, else effectively EXACT
            resolved = effective_attn_config(resolved)
        seen[(ev.path, ev.kind)] = SiteRecord(
            path=ev.path, kind=ev.kind, config=resolved,
            dtype=ev.dtype, dims=ev.dims, macs=ev.macs, repeat=ev.repeat)
    sites = tuple(seen[k] for k in sorted(seen, key=lambda k: k[0]))
    return SiteGraph(cfg=cfg, policy=candidate, sites=sites,
                     segments=_collect_segments(model))
