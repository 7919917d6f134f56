"""Backend dispatcher: resolve a site's numerics, validate, execute.

The single injection point between models and the DAISM GEMM:

* :func:`policy_dot`, :func:`policy_conv2d` and
  :func:`policy_expert_matmul` are what models call:
  ``policy_dot(policy, x, w, name=..., kind=...)`` resolves the site under
  the ambient :mod:`~repro_torch.policy.sites` scope and runs it;
  :func:`make_dot` binds one policy into such a ``dot`` callable.
* Backend/dtype combinations are validated at resolution (actionable errors
  naming the site), and the decision is recorded in a per-policy resolution
  log with the site's multiply count.
* GEMM and flash-attention callables are cached per distinct resolved
  :class:`DaismConfig` (:func:`matmul_kernel`, :func:`attention_kernel`);
  :func:`kernel_stats` exposes the GEMM cache counters.

* :func:`observe_sites` delivers a :class:`SiteEvent` (with the GEMM's
  dims) for every site resolved inside it.
* :func:`site_report` and :func:`estimated_energy_uj` price the logged
  sites with the paper's analytical energy model (``core/energy.py``).

The log records a site every time it runs, so it holds the last *executed*
shape of each site; the reference records at trace time (the last *traced*
shape). After one forward at one shape the two logs, and the reports, are
the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.config import Backend, DaismConfig, Variant, dtype_name

from .policy import EXACT, ApproxPolicy, describe_config
from .sites import OpKind, current_path, current_repeat

_GEMM_DTYPES = ("bfloat16", "float32")


def effective_attn_config(cfg: DaismConfig, *,
                          eligible: bool = True) -> DaismConfig:
    """The config an attention-score site (OpKind.ATTN_QK) actually runs.

    Attention numerics follow the resolved config only when it opts into the
    fused flash kernel (``attn_kernel='flash'``) *and* the call shape is
    flash-eligible; otherwise the site executes the exact online-softmax
    path, so its effective config is EXACT. A catch-all rule like
    ``*=pc3_tr`` therefore never changes attention numerics.
    """
    if cfg.attn_kernel == "flash" and eligible:
        return cfg
    return EXACT


def validate_for_dtype(cfg: DaismConfig, dtype, *, site: str = "") -> None:
    """Raise an actionable error if ``cfg`` cannot run on ``dtype`` operands.

    Called at resolve time (and by ``ArchConfig`` at construction via its
    compute dtype) so misconfigurations fail before any kernel runs.
    """
    if cfg.exact:
        return
    where = f"site {site!r}: " if site else ""
    name = dtype_name(dtype)
    if name not in _GEMM_DTYPES:
        raise ValueError(
            f"{where}DAISM approximate GEMMs support bfloat16/float32 "
            f"operands, got {name}; run this site exact or change the "
            "compute dtype")
    if cfg.backend.value in ("lut", "pallas") and name != "bfloat16":
        raise ValueError(
            f"{where}backend {cfg.backend.value!r} is bfloat16-only "
            f"(256x256 mantissa table / Pallas kernel), got {name}; use "
            "backend='jnp' for float32 or switch the compute dtype to "
            "bfloat16")


# ---------------------------------------------------------------------------
# Resolution log (per-policy, per-site)
# ---------------------------------------------------------------------------

# policy -> {(path, kind): (config, dtype_name, macs_per_call)}
_LOG: Dict[ApproxPolicy, Dict[Tuple[str, OpKind],
                              Tuple[DaismConfig, str, int]]] = {}
_STATS = {"kernel_builds": 0, "attention_calls": 0}


def clear_log(policy: Optional[ApproxPolicy] = None) -> None:
    if policy is None:
        _LOG.clear()
    else:
        _LOG.pop(policy, None)


def resolution_log(policy: ApproxPolicy) -> Dict[Tuple[str, OpKind],
                                                 Tuple[DaismConfig, str, int]]:
    """Sites resolved so far for ``policy`` (only sites that ran appear)."""
    return dict(_LOG.get(policy, {}))


def _record(policy: ApproxPolicy, path: str, kind: OpKind, cfg: DaismConfig,
            dtype, macs: int) -> None:
    _LOG.setdefault(policy, {})[(path, kind)] = (
        cfg, dtype_name(dtype), int(macs))


# ---------------------------------------------------------------------------
# Site observers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SiteEvent:
    """One resolved contraction site.

    ``dims = (m, k, n)`` are the dims of a single kernel invocation (leading
    batch axes folded into ``m``). ``macs`` is the total multiply count of
    the site including the ambient segment ``repeat``.
    """

    path: str
    kind: OpKind
    config: DaismConfig
    dtype: str
    dims: Tuple[int, int, int]
    macs: int
    repeat: int


_OBSERVERS: List[Callable[[SiteEvent], None]] = []


@contextlib.contextmanager
def observe_sites(callback: Callable[[SiteEvent], None]):
    """Deliver a :class:`SiteEvent` to ``callback`` for every site resolved
    (with ``record=True``) inside the with-block."""
    _OBSERVERS.append(callback)
    try:
        yield
    finally:
        _OBSERVERS.remove(callback)


def _energy_per_mult_pj(cfg: DaismConfig, dtype_name: str) -> float:
    """Estimated pJ per multiplication (core/energy model, Eq 4-6)."""
    from repro_torch.core import energy as E

    if dtype_name not in ("bfloat16", "float32"):
        dtype_name = "float32"
    exp = E.exponent_handling_energy(dtype_name)
    if cfg.exact:
        return E.total(E.eyeriss_energy_per_mult(
            dtype_name, truncated=False)) + exp
    return E.total(E.daism_energy_per_mult(cfg.variant, dtype_name)) + exp


def energy_per_mult_pj(cfg: DaismConfig, dtype_name: str) -> float:
    """Public per-mult energy estimate (the site graph's records use it)."""
    return _energy_per_mult_pj(cfg, dtype_name)


def site_report(policy: ApproxPolicy) -> str:
    """Human-readable per-site resolution table with energy estimates.

    Covers the sites run so far under ``policy``; ``macs`` is the multiply
    count of the most recent call of each site (batch-shaped), and the
    energy column is macs x the analytical per-mult model.
    """
    log = _LOG.get(policy, {})
    if not log:
        return (f"policy {policy.name or '<anonymous>'}: "
                "no sites resolved yet (trace a model first)")
    rows, total_pj, exact_pj = [], 0.0, 0.0
    for (path, kind), (cfg, dtype_name, macs) in sorted(log.items()):
        pj = macs * _energy_per_mult_pj(cfg, dtype_name)
        base = macs * _energy_per_mult_pj(
            DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT),
            dtype_name)
        total_pj += pj
        exact_pj += base
        rows.append((path, kind.value, describe_config(cfg), macs, pj))
    width = max(len(r[0]) for r in rows)
    lines = [f"== per-site resolution ({policy.name or '<anonymous>'}) =="]
    for path, kind, conf, macs, pj in rows:
        lines.append(f"  {path:<{width}}  {kind:<10s} {conf:<18s} "
                     f"{macs:>12,d} mults  {pj / 1e6:>10.2f} uJ")
    if exact_pj > 0:
        lines.append(
            f"  estimated multiply energy {total_pj / 1e6:.2f} uJ "
            f"(saves {100 * (1 - total_pj / exact_pj):.1f}% vs all-exact "
            f"{exact_pj / 1e6:.2f} uJ)")
    return "\n".join(lines)


def estimated_energy_uj(policy: ApproxPolicy) -> Tuple[float, float]:
    """(policy_energy, all_exact_energy) in uJ over the logged sites."""
    log = _LOG.get(policy, {})
    total = base = 0.0
    exact_cfg = DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT)
    for (_, _), (cfg, dtype_name, macs) in log.items():
        total += macs * _energy_per_mult_pj(cfg, dtype_name)
        base += macs * _energy_per_mult_pj(exact_cfg, dtype_name)
    return total / 1e6, base / 1e6


# ---------------------------------------------------------------------------
# Kernel cache
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def matmul_kernel(cfg: DaismConfig) -> Callable:
    """One 2-D approximate matmul callable per distinct resolved config;
    its ``experts`` attribute runs (E, C, K) @ (E, K, N) expert batches."""
    from repro_torch.core.gemm import daism_expert_matmul, daism_matmul

    _STATS["kernel_builds"] += 1

    def kernel(a, w):
        return daism_matmul(a, w, cfg)

    def experts(x, w):
        # one call for all the experts: the reference vmaps ``kernel``
        return daism_expert_matmul(x, w, cfg)

    kernel.experts = experts
    return kernel


@functools.lru_cache(maxsize=None)
def attention_kernel(cfg: DaismConfig) -> Callable:
    """One flash-attention callable per distinct resolved config.

    ``kernel(q, k, v, causal)`` takes (B, S, H, D) tensors (grouped-query
    heads and ragged lengths are handled by ``flash_attention_bhsd``). Exact
    configs run the kernel with f32 contractions (``variant=None``);
    approximate configs fuse the config's DAISM product into QK and PV.
    The kernel has no gradient, as in the reference: asked for one, it
    raises. Builds count in ``_STATS["kernel_builds"]`` (with the GEMMs'),
    calls in ``_STATS["attention_calls"]``.
    """
    from repro_torch.kernels.flash_attention import flash_attention_bhsd

    _STATS["kernel_builds"] += 1
    variant = None if cfg.exact else cfg.variant

    def kernel(q, k, v, causal):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "flash attention has no backward: the JAX package's flash "
                "kernel (repro/kernels/flash_attention.py) has no custom_vjp "
                "and jax.grad cannot go through its pallas_call; train under "
                "a policy without ':flash' or run under torch.no_grad()")
        _STATS["attention_calls"] += 1
        return flash_attention_bhsd(q, k, v, causal=causal, variant=variant)

    return kernel


def kernel_stats() -> Dict[str, int]:
    info = matmul_kernel.cache_info()
    return dict(_STATS, cache_hits=info.hits, cache_misses=info.misses,
                cached_kernels=info.currsize)


# ---------------------------------------------------------------------------
# Injection points
# ---------------------------------------------------------------------------


def resolve_site(policy: ApproxPolicy, name: str, kind: OpKind, dtype,
                 *, record: bool = True, macs: int = 0,
                 dims: Tuple[int, int, int] = (0, 0, 0),
                 attn_eligible: bool = True) -> DaismConfig:
    """Resolve + validate the config for the site named ``name`` under the
    ambient site scope. Returns the (frozen) resolved DaismConfig.

    ATTN_QK sites resolve to their *effective* config (see
    :func:`effective_attn_config`).
    """
    path = current_path(name)
    kind = OpKind(kind)
    cfg = policy.resolve(path, kind)
    if kind is OpKind.ATTN_QK:
        cfg = effective_attn_config(cfg, eligible=attn_eligible)
        if not cfg.exact and dtype_name(dtype) != "bfloat16":
            raise ValueError(
                f"site {path!r}: flash attention with a DAISM variant is "
                f"bfloat16-only (got {dtype_name(dtype)}); run the site "
                "exact (drop the variant, keep ':flash') or switch the "
                "compute dtype to bfloat16")
    validate_for_dtype(cfg, dtype, site=path)
    if record:
        repeat = current_repeat()
        _record(policy, path, kind, cfg, dtype, macs * repeat)
        for cb in _OBSERVERS:
            cb(SiteEvent(path=path, kind=kind, config=cfg,
                         dtype=dtype_name(dtype), dims=dims,
                         macs=macs * repeat, repeat=repeat))
    return cfg


def policy_dot(policy: ApproxPolicy, x, w, *, name: str,
               kind: OpKind = OpKind.DENSE, record: bool = True,
               global_kn: Optional[Tuple[int, int]] = None):
    """``x @ w`` over the last axis of ``x`` with site-resolved numerics.

    Exact sites keep the plain deployment matmul (weights cast to the
    activation dtype); approximate sites run the DAISM GEMM through the
    per-config kernel cache. Output dtype always matches ``x``.

    ``global_kn``: the (K, N) of the whole GEMM when ``x``/``w`` are one
    rank's shards of it (tensor parallelism); the site is recorded at its
    global shape, as the reference traces a dense site outside
    ``shard_map``.
    """
    k = x.shape[-1]
    n = w.shape[-1]
    m = x.numel() // k if k else 0
    gk, gn = global_kn or (k, n)
    cfg = resolve_site(policy, name, kind, x.dtype, record=record,
                       macs=m * int(gk) * int(gn), dims=(m, int(gk), int(gn)))
    if cfg.exact:
        return x @ w.to(x.dtype)
    out = matmul_kernel(cfg)(x.reshape(-1, k), w)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)


def policy_expert_matmul(policy: ApproxPolicy, x, w, *, name: str,
                         record: bool = True):
    """(E, C, d) x (E, d, f) -> (E, C, f) batched expert GEMM.

    The site is an ``OpKind.MOE_EXPERT`` with ``macs = E*C*d*f`` and the
    dims of one expert's product ``(C, d, f)``. Exact sites run the plain
    batched product; approximate sites run the DAISM GEMM once for every
    expert (one kernel launch on the ``pallas`` backend, ``x`` may be an
    expert-broadcast view). The output has ``x``'s dtype.
    """
    e, c, d = x.shape
    f = w.shape[-1]
    cfg = resolve_site(policy, name, OpKind.MOE_EXPERT, x.dtype,
                       record=record, macs=e * c * d * f, dims=(c, d, f))
    if cfg.exact:
        return torch.bmm(x, w.to(x.dtype))
    return matmul_kernel(cfg).experts(x, w).to(x.dtype)


def make_dot(policy: ApproxPolicy) -> Callable:
    """Bind ``policy`` into a ``dot(x, w, *, name, kind, record)`` callable,
    the injectable matmul models consume."""
    return functools.partial(policy_dot, policy)


def policy_conv2d(policy: ApproxPolicy, x, kernel, *, name: str,
                  stride: int = 1, padding: str = "SAME",
                  record: bool = True):
    """NHWC conv with site-resolved numerics (im2col + DAISM GEMM when the
    site resolves approximate, the library convolution when exact). The
    site is an ``OpKind.CONV`` with the im2col GEMM's dims
    ``(N*Ho*Wo, kh*kw*cin, cout)``; the output has ``x``'s dtype."""
    from repro_torch.core.gemm import conv2d_im2col

    kh, kw, cin, cout = kernel.shape
    nb, h, wdim = x.shape[0], x.shape[1], x.shape[2]
    if padding == "SAME":
        ho, wo = -(-h // stride), -(-wdim // stride)
    else:  # VALID
        ho, wo = -(-(h - kh + 1) // stride), -(-(wdim - kw + 1) // stride)
    macs = nb * ho * wo * kh * kw * cin * cout
    cfg = resolve_site(policy, name, OpKind.CONV, x.dtype, record=record,
                       macs=macs, dims=(nb * ho * wo, kh * kw * cin, cout))
    return conv2d_im2col(x, kernel.to(x.dtype), cfg, stride=stride,
                         padding=padding).to(x.dtype)
