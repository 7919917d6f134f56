"""Backend dispatcher: resolve a site's numerics, validate, execute.

The single injection point between models and the DAISM GEMM:

* :func:`policy_dot` is what models call: ``policy_dot(policy, x, w,
  name=..., kind=...)`` resolves the site under the ambient
  :mod:`~repro_torch.policy.sites` scope and runs it.
* Backend/dtype combinations are validated at resolution (actionable errors
  naming the site), and the decision is recorded in a per-policy resolution
  log with the site's multiply count.
* GEMM callables are cached per distinct resolved :class:`DaismConfig`
  (:func:`matmul_kernel`); :func:`kernel_stats` exposes the cache counters.

The energy report (``site_report``, ``estimated_energy_uj``) and the
analyzer's ``observe_sites`` hook need ``core/energy.py`` and ``analyze/``,
which come with a later part of the port.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.config import DaismConfig, dtype_name

from .policy import EXACT, ApproxPolicy
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
_STATS = {"kernel_builds": 0, "kernel_calls": 0}


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
# Kernel cache
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def matmul_kernel(cfg: DaismConfig) -> Callable:
    """One 2-D approximate matmul callable per distinct resolved config."""
    from repro_torch.core.gemm import daism_matmul

    _STATS["kernel_builds"] += 1

    def kernel(a, w):
        _STATS["kernel_calls"] += 1
        return daism_matmul(a, w, cfg)

    return kernel


def attention_kernel(cfg: DaismConfig) -> Callable:
    """The fused flash-attention kernel: not ported yet."""
    raise NotImplementedError(
        "flash attention is not ported yet; see ROADMAP §B2")


def kernel_stats() -> Dict[str, int]:
    info = matmul_kernel.cache_info()
    return dict(_STATS, cache_hits=info.hits, cache_misses=info.misses,
                cached_kernels=info.currsize)


# ---------------------------------------------------------------------------
# Injection points
# ---------------------------------------------------------------------------


def resolve_site(policy: ApproxPolicy, name: str, kind: OpKind, dtype,
                 *, record: bool = True, macs: int = 0,
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
        _record(policy, path, kind, cfg, dtype, macs * current_repeat())
    return cfg


def policy_dot(policy: ApproxPolicy, x, w, *, name: str,
               kind: OpKind = OpKind.DENSE, record: bool = True):
    """``x @ w`` over the last axis of ``x`` with site-resolved numerics.

    Exact sites keep the plain deployment matmul (weights cast to the
    activation dtype); approximate sites run the DAISM GEMM through the
    per-config kernel cache. Output dtype always matches ``x``.
    """
    k = x.shape[-1]
    n = w.shape[-1]
    m = x.numel() // k if k else 0
    cfg = resolve_site(policy, name, kind, x.dtype, record=record,
                       macs=m * int(k) * int(n))
    if cfg.exact:
        return x @ w.to(x.dtype)
    out = matmul_kernel(cfg)(x.reshape(-1, k), w)
    return out.reshape(*x.shape[:-1], n).to(x.dtype)
