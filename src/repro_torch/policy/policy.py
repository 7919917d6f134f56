"""Approximation policies: ordered site-pattern rules -> DaismConfig.

An :class:`ApproxPolicy` is a frozen, hashable value (it keys the
dispatcher's caches and the engine's policy groups) holding an ordered tuple of :class:`Rule`. Resolution is
first-match-wins over the rules, falling back to ``default``.

Rule patterns are ``fnmatch`` globs over the site path (``*`` crosses ``/``
separators, so ``*/attn/*`` matches ``decoder/layer_3/attn/wq``). A pattern
starting with ``@`` matches the site's :class:`~repro_torch.policy.sites.OpKind`
value instead (``@lm_head``, ``@conv``, ``@moe_expert``).

Spec mini-language (CLI ``--policy`` flags, :func:`parse_policy`)::

    */attn/*=exact,*/layer_0/*=exact,@lm_head=exact,*=pc3_tr

Each comma-separated rule is ``pattern=variant[:backend][:flash]`` (the
``flash`` token opts attention-score sites into the fused Pallas kernel); a
trailing ``*=...`` rule (or the ``default=`` key) sets the fallback config.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Callable, Iterable, Optional, Sequence, Tuple

from repro_torch.core.config import Backend, DaismConfig, Variant

from .sites import OpKind

EXACT = DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One policy rule: glob ``pattern`` over site paths -> ``config``.

    ``pattern`` beginning with ``@`` matches the OpKind value instead of the
    path (e.g. ``@lm_head``). ``kind`` additionally restricts a path pattern
    to one OpKind when set.
    """

    pattern: str
    config: DaismConfig
    kind: Optional[OpKind] = None

    def matches(self, path: str, kind: OpKind) -> bool:
        if self.kind is not None and kind is not self.kind:
            return False
        if self.pattern.startswith("@"):
            return self.pattern[1:] == kind.value
        return fnmatch.fnmatchcase(path, self.pattern)


@dataclasses.dataclass(frozen=True)
class ApproxPolicy:
    """Ordered first-match-wins mapping of op-sites to DAISM numerics.

    Frozen + hashable: keys the dispatcher's kernel/resolution caches and
    the serving engine's policy groups. Build one with the
    constructors below, :func:`parse_policy`, or directly from rules.
    """

    rules: Tuple[Rule, ...] = ()
    default: DaismConfig = EXACT
    name: str = ""

    def resolve(self, path: str, kind: OpKind = OpKind.DENSE) -> DaismConfig:
        """First matching rule's config, else ``default``."""
        return _resolve_cached(self, path, OpKind(kind))

    # -- constructors ------------------------------------------------------

    @classmethod
    def uniform(cls, config: DaismConfig, name: str = "") -> "ApproxPolicy":
        """Every site uses ``config`` (the legacy ``ArchConfig.daism`` shape)."""
        return cls(rules=(), default=config,
                   name=name or f"uniform:{config.variant.value}")

    @classmethod
    def first_last_exact(cls, base: DaismConfig, n_layers: int,
                         name: str = "") -> "ApproxPolicy":
        """First layer, last layer, and the lm_head run exact; the rest
        (the error-tolerant middle of the network) uses ``base``."""
        rules = (
            Rule("*/layer_0/*", EXACT),
            Rule(f"*/layer_{n_layers - 1}/*", EXACT),
            Rule("@lm_head", EXACT),
        )
        return cls(rules=rules, default=base,
                   name=name or f"first_last_exact:{base.variant.value}")

    @classmethod
    def attention_exact(cls, base: DaismConfig,
                        name: str = "") -> "ApproxPolicy":
        """Attention projections stay exact; everything else uses ``base``."""
        rules = (Rule("*/attn/*", EXACT), Rule("*/xattn/*", EXACT))
        return cls(rules=rules, default=base,
                   name=name or f"attention_exact:{base.variant.value}")

    @classmethod
    def depth_schedule(cls, configs: Sequence[DaismConfig],
                       default: DaismConfig = EXACT,
                       name: str = "") -> "ApproxPolicy":
        """``configs[i]`` applies to every site under ``*/layer_{i}/*``.

        Sites outside any layer scope (e.g. the lm_head) use ``default``.
        """
        rules = tuple(Rule(f"*/layer_{i}/*", c)
                      for i, c in enumerate(configs))
        return cls(rules=rules, default=default, name=name or "depth_schedule")

    # -- introspection -----------------------------------------------------

    def describe(self) -> str:
        lines = [f"policy {self.name or '<anonymous>'}:"]
        for r in self.rules:
            kind = f" [{r.kind.value}]" if r.kind else ""
            lines.append(f"  {r.pattern}{kind} -> {describe_config(r.config)}")
        lines.append(f"  * -> {describe_config(self.default)} (default)")
        return "\n".join(lines)


@functools.lru_cache(maxsize=4096)
def _resolve_cached(policy: ApproxPolicy, path: str,
                    kind: OpKind) -> DaismConfig:
    for rule in policy.rules:
        if rule.matches(path, kind):
            return rule.config
    return policy.default


def describe_config(cfg: DaismConfig) -> str:
    flash = cfg.attn_kernel == "flash"
    if cfg.exact:
        return "exact:flash" if flash else "exact"
    tags = [cfg.variant.value, cfg.backend.value]
    if flash:
        tags.append("flash")
    if cfg.calibrated:
        tags.append("calibrated")
    if cfg.backward == "approx":
        tags.append("bwd=approx")
    return ":".join(tags)


# ---------------------------------------------------------------------------
# Spec parsing (CLI mini-language)
# ---------------------------------------------------------------------------

_VARIANT_NAMES = {v.value for v in Variant}
_BACKEND_NAMES = {b.value for b in Backend}


def parse_config(spec: str) -> DaismConfig:
    """``variant[:backend][:flash]`` -> DaismConfig.

    ``exact`` -> the exact config; a trailing ``flash`` token sets
    ``attn_kernel='flash'`` so attention-score sites matched by the rule
    dispatch to the fused Pallas flash-attention kernel (``exact:flash``
    runs it with MXU contractions; ``pc3_tr:flash`` fuses the approximate
    products). Without it, attention-score sites stay on the exact jnp
    online-softmax path whatever the rule's numerics say.
    """
    parts = spec.strip().split(":")
    attn_kernel = "jnp"
    if len(parts) > 1 and parts[-1] == "flash":
        attn_kernel = "flash"
        parts = parts[:-1]
    variant = parts[0]
    if variant not in _VARIANT_NAMES:
        raise ValueError(
            f"unknown variant {variant!r}; expected one of "
            f"{sorted(_VARIANT_NAMES)}")
    if variant == Variant.EXACT.value:
        if len(parts) > 1:
            raise ValueError(f"config spec {spec!r}: 'exact' takes no "
                             "backend (only an optional ':flash')")
        return EXACT if attn_kernel == "jnp" else EXACT.replace(
            attn_kernel="flash")
    backend = parts[1] if len(parts) > 1 else Backend.JNP.value
    if backend not in _BACKEND_NAMES:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of "
            f"{sorted(_BACKEND_NAMES)}")
    if len(parts) > 2:
        raise ValueError(f"config spec {spec!r} has too many ':' fields "
                         "(expected variant[:backend][:flash])")
    return DaismConfig(variant=Variant(variant), backend=Backend(backend),
                       attn_kernel=attn_kernel)


def parse_policy(spec: str, default: DaismConfig = EXACT,
                 name: str = "") -> ApproxPolicy:
    """Parse ``pattern=variant[:backend],...`` into an ApproxPolicy.

    Entries become rules in the order given (first match wins), so a ``*=``
    catch-all shadows everything after it; a ``default=...`` entry sets the
    fallback for sites no rule matches (``exact`` unless overridden).

    Two rules with the same glob are rejected outright (the second can never
    fire); non-identical overlaps are the linter's shadowing check
    (``repro.analyze`` in the JAX package), not a parse error.
    """
    rules = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"bad policy rule {item!r}: expected pattern=variant[:backend]")
        pattern, _, conf = item.partition("=")
        pattern = pattern.strip()
        cfg = parse_config(conf)
        if pattern == "default":
            default = cfg
        else:
            for j, prev in enumerate(rules):
                if prev.pattern == pattern and prev.kind is None:
                    raise ValueError(
                        f"duplicate policy rule for pattern {pattern!r}: "
                        f"rules {j} ({prev.pattern}="
                        f"{describe_config(prev.config)}) and {len(rules)} "
                        f"({pattern}={describe_config(cfg)}) target the same "
                        "glob — first match wins, the second can never fire")
            rules.append(Rule(pattern, cfg))
    return ApproxPolicy(rules=tuple(rules), default=default,
                        name=name or spec)


# ---------------------------------------------------------------------------
# Scan segmentation
# ---------------------------------------------------------------------------

SitesFn = Callable[[int], Iterable[Tuple[str, OpKind]]]


def layer_signature(policy: ApproxPolicy, sites: Iterable[Tuple[str, OpKind]]
                    ) -> Tuple[DaismConfig, ...]:
    """Resolved configs for a layer's probe sites (its policy fingerprint).

    ATTN_QK probes use the *effective* attention config (what the layer
    actually runs — see ``dispatch.effective_attn_config``), so a catch-all
    numerics rule that leaves attention on the exact path doesn't split
    segments over a difference that never reaches a kernel.
    """
    from .dispatch import effective_attn_config

    out = []
    for path, kind in sites:
        cfg = policy.resolve(path, kind)
        if OpKind(kind) is OpKind.ATTN_QK:
            cfg = effective_attn_config(cfg)
        out.append(cfg)
    return tuple(out)


def plan_segments(policy: ApproxPolicy, sites_fn: SitesFn, lo: int, hi: int
                  ) -> Tuple[Tuple[int, int], ...]:
    """Partition layers ``[lo, hi)`` into maximal runs with identical
    resolved configs; each run executes under one site scope (its first
    layer), as one ``lax.scan`` trace does in the JAX package.

    ``sites_fn(i)`` yields the (path, kind) probe sites of layer ``i`` —
    every contraction site the layer contains, with the exact paths the
    model will use. A uniform policy yields a single segment.
    """
    if hi <= lo:
        return ()
    segments = []
    start = lo
    sig = layer_signature(policy, sites_fn(lo))
    for i in range(lo + 1, hi):
        s = layer_signature(policy, sites_fn(i))
        if s != sig:
            segments.append((start, i))
            start, sig = i, s
    segments.append((start, hi))
    return tuple(segments)
