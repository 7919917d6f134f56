"""Continuous-batching engine over a paged KV cache: per-request policy
tiers, chunked prefill, prefix caching, an asynchronous tick loop,
preemption/swap and self-speculative decoding.

Ported from ``repro/serve/engine.py``:

* **Paged KV pool** — one physical page pool for the whole engine:
  ``k/v: (layers, num_blocks * block_size + 1, kv_heads, head_dim)`` (the
  extra cell absorbs dropped writes). A request owns a *block table*
  (kv_pool.BlockPool); full prompt blocks are ref-counted and
  content-addressed (prefix caching).
* **One step, block tables inside** — ``DecoderLM.paged_step`` resolves
  block tables to gather/scatter indices inside the step: decode (S=1) and
  chunked prefill (S=prefill_chunk) are two fixed shapes of one function.
  The step updates the KV pool in place, where the reference donates it to
  a jit'd step.
* **Async tick loop** — each tick *launches* every group's prefill + decode
  steps, then does the host-side work (arrival stamping, admission + page
  reservation) while the card computes, and only then fetches the tokens.
  Inputs go to the card through pinned host memory with non-blocking
  copies, so no launch waits for the card; the token fetch is the one wait.
  ``overlap=False`` fetches right after each launch (the sync baseline).
* **Policy groups** — each request carries an approximation policy (tier
  name from ``EngineConfig.tiers``, a raw spec, an ``ApproxPolicy``, or
  None = the base model's). Requests batch by resolved policy: one scheduler
  and one step per group, all groups sharing the page pool and the params.
* **Preemption/swap** — ``preempt=True`` switches admission from
  whole-lifetime page reservation to optimistic prompt-only allocation
  with on-demand ``extend`` at every block boundary. Under page exhaustion
  the engine swaps the lowest-priority (tie: youngest) *decoding* request
  out to a host-side buffer — an exact gather of its pages — frees its
  blocks and rows, and resumes it later token-identically (a scatter back
  through a fresh table; unmapped entries go to the pool's sink cell). The
  swap buffer holds at most ``swap_blocks`` pages (0 = one full request);
  an undersized buffer stalls instead of deadlocking. Admission may
  preempt only strictly-lower-priority victims; extension of a running
  request may preempt equals (LIFO), so older requests finish.
* **Self-speculative decoding** — ``spec_draft``/``spec_k`` chain
  ``spec_k`` S=1 draft steps under a cheap approximate policy (the same
  parameter tensors: DAISM's approximate multiplier is a free
  weight-sharing draft model) and verify all candidates in one batched
  S=spec_k+1 step under the group's own policy
  (``DecoderLM.paged_verify_step``), with no host wait between them.
  Greedy accept/reject + bonus token keeps the output token-identical to
  plain decode; drafted K/V is scratch the verify overwrites in place, the
  pool truncates pages past the accepted length, and a per-group
  acceptance EWMA turns speculation off where it does not pay.
* **Accounting** — per-request TTFT / latency, inter-token gaps, tok/s,
  step percentiles, KV utilization, peak concurrency, prefix-cache hits,
  preemptions/resumes, speculation, host idle time, and the steps each
  group launched.

* **Tensor-parallel sharding** — pass ``mesh=`` (a ``DeviceMesh`` with a
  ``model`` axis, ``repro_torch.launch.mesh.make_mesh``) and the engine
  lays the parameters out with the serve Sharder rules
  (``convert.shard_params``: this rank keeps its shards), keeps this
  rank's kv heads in the page pool, and runs every model step under the
  sharder: the layers are column/row-parallel with explicit all-reduces,
  the embedding and the logits vocab-parallel, the paged attention
  head-local (``models/layers.py``), and MoE layers expert-parallel
  (``models/moe.py``). Every rank runs this same host loop: no scheduling
  decision depends on a clock, and every rank takes the argmax of the same
  all-gathered logits, so the ranks stay in step and every collective
  meets. ``EngineConfig.shards`` documents the layout; blocks and
  num_slots must divide by it (daism-lint SRV007). Port-only limits: the
  mesh's other axes must have size 1, and n_heads and kv_heads must divide
  by the model axis (the reference falls back to a replicated pool there).

Greedy (argmax) sampling keeps the output deterministic, so the same
requests give the same tokens as the JAX engine on the same weights.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.models.module import flatten
from repro_torch.policy import ApproxPolicy, parse_policy
from repro_torch.runtime import trace
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.watchdog import StepWatchdog

from .kv_pool import SENTINEL, BlockPool, blocks_needed
from .scheduler import Request, RequestState, Scheduler


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def parse_tiers(spec: str) -> Tuple[Tuple[str, str], ...]:
    """``"free=*=pc3_tr;paid=*/attn/*=exact"`` -> (("free", "*=pc3_tr"), ...).

    Tiers are ';'-separated ``name=policy-spec`` entries (the spec itself
    contains '=' and ',', so only the first '=' splits)."""
    tiers = []
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        name, sep, policy = item.partition("=")
        if not sep or not name.strip() or not policy.strip():
            raise ValueError(
                f"bad tier entry {item!r}: expected name=policy-spec "
                "(e.g. 'free=*=pc3_tr')")
        tiers.append((name.strip(), policy.strip()))
    return tuple(tiers)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Paged-serving engine configuration (the JAX package's fields).

    ``num_slots`` is the decode-batch width of each policy group, decoupled
    from KV memory: ``num_blocks`` pages of ``block_size`` cells bound how
    many tokens of K/V exist at once (0 = ``num_slots * max_seq /
    block_size``). ``tiers`` registers named policy specs requests can
    reference. ``overlap=False`` disables the async tick loop.

    ``preempt`` switches whole-lifetime page reservation to optimistic
    allocation + swap-out under exhaustion (``swap_blocks`` pages of host
    buffer, 0 = one full request).

    ``spec_draft`` + ``spec_k`` enable self-speculative decoding: every
    decode tick drafts ``spec_k`` tokens per row under the (cheap,
    weight-sharing) ``spec_draft`` policy — a tier name or raw spec — then
    one batched verify step under the group's own policy accepts the
    longest matching prefix plus a bonus token (token-identical to plain
    greedy decode). A per-group EWMA of the draft acceptance rate
    auto-disables speculation below ``spec_min_accept``.

    ``shards`` declares the mesh serving-axis (``model``) size the engine
    is laid out for: pass the matching mesh to ``ServeEngine``; blocks and
    num_slots must both divide by it.
    """

    num_slots: int = 4
    max_seq: int = 128
    block_size: int = 16
    num_blocks: int = 0
    prefill_chunk: int = 16
    eos_id: Optional[int] = None
    tiers: Tuple[Tuple[str, str], ...] = ()
    shards: int = 1
    preempt: bool = False
    swap_blocks: int = 0
    overlap: bool = True
    spec_draft: str = ""
    spec_k: int = 0
    spec_min_accept: float = 0.25

    def __post_init__(self) -> None:
        for field in ("num_slots", "max_seq", "block_size", "prefill_chunk",
                      "shards"):
            v = getattr(self, field)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"EngineConfig.{field} must be a positive int "
                    f"(got {v!r})")
        if self.num_blocks < 0:
            raise ValueError(
                f"EngineConfig.num_blocks must be >= 0 "
                f"(0 = auto; got {self.num_blocks})")
        if self.swap_blocks < 0:
            raise ValueError(
                f"EngineConfig.swap_blocks must be >= 0 "
                f"(0 = one request's worth; got {self.swap_blocks})")
        if self.max_seq % self.block_size:
            raise ValueError(
                f"EngineConfig.max_seq ({self.max_seq}) must be a multiple "
                f"of block_size ({self.block_size}): block tables map whole "
                "pages")
        if self.prefill_chunk > self.max_seq:
            raise ValueError(
                f"EngineConfig.prefill_chunk ({self.prefill_chunk}) must be "
                f"<= max_seq ({self.max_seq})")
        if self.prefill_chunk & (self.prefill_chunk - 1):
            raise ValueError(
                f"EngineConfig.prefill_chunk ({self.prefill_chunk}) must be "
                "a power of two (one compiled prefill shape)")
        if not isinstance(self.spec_k, int) or self.spec_k < 0:
            raise ValueError(
                f"EngineConfig.spec_k must be an int >= 0 "
                f"(0 = speculation off; got {self.spec_k!r})")
        if not isinstance(self.spec_draft, str):
            raise ValueError(
                "EngineConfig.spec_draft must be a tier name or policy spec "
                f"string (got {type(self.spec_draft).__name__})")
        if bool(self.spec_k) != bool(self.spec_draft):
            raise ValueError(
                "EngineConfig: spec_draft and spec_k enable speculative "
                "decoding together — set both (spec_draft=<tier|spec>, "
                f"spec_k>=1) or neither (got spec_draft={self.spec_draft!r}, "
                f"spec_k={self.spec_k})")
        if self.spec_k >= self.max_seq:
            raise ValueError(
                f"EngineConfig.spec_k ({self.spec_k}) must be < max_seq "
                f"({self.max_seq}): the verify window is spec_k+1 positions "
                "of one request's cache")
        if not 0.0 <= self.spec_min_accept <= 1.0:
            raise ValueError(
                f"EngineConfig.spec_min_accept must be in [0, 1] "
                f"(got {self.spec_min_accept})")
        if isinstance(self.tiers, dict):  # ergonomics: accept a dict
            object.__setattr__(self, "tiers", tuple(self.tiers.items()))
        for name, spec in self.tiers:
            if not isinstance(name, str) or not isinstance(spec, str):
                raise ValueError(
                    f"EngineConfig.tiers entries must be (name, spec) "
                    f"string pairs (got {(name, spec)!r})")

    def validate_for_model(self, model_cfg) -> None:
        """Model/engine compatibility: a windowed (ring-buffer) cache can
        never be paged."""
        window = getattr(model_cfg, "window", 0)
        if window:
            raise ValueError(
                f"EngineConfig: ArchConfig.window={window} (on "
                f"{getattr(model_cfg, 'name', '?')!r}) is incompatible with "
                "the paged KV cache — ring buffers roll in place, pages are "
                "freed whole; serve with window=0 (e.g. cfg.smoke(window=0))")

    @property
    def blocks(self) -> int:
        """Physical pool pages (resolves the ``num_blocks=0`` default)."""
        return self.num_blocks or self.num_slots * (self.max_seq
                                                    // self.block_size)

    @property
    def max_blocks_per_seq(self) -> int:
        return self.max_seq // self.block_size

    @property
    def swap_capacity(self) -> int:
        """Host swap buffer size in pages (0 when preemption is off)."""
        if not self.preempt:
            return 0
        return self.swap_blocks or self.max_blocks_per_seq


@dataclasses.dataclass
class ServeReport:
    """Aggregate accounting for one engine run.

    Percentiles are unfiltered wall times. In async mode (``overlap=True``)
    step times span launch -> fetch, so they include the overlapped host
    work; ``host_idle_s`` counts only the time blocked on token fetches."""

    completed: List[RequestState]
    wall_s: float
    prefill_s: float
    decode_s: float
    decode_steps: int
    generated_tokens: int
    tokens_per_s: float
    ttft_p50_ms: float
    ttft_p95_ms: float
    ttft_p99_ms: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_p99_ms: float
    tok_lat_p50_ms: float
    tok_lat_p95_ms: float
    tok_lat_p99_ms: float
    step_p50_ms: float
    step_p99_ms: float
    joined_mid_stream: int
    straggler_steps: int
    ticks: int
    host_idle_s: float
    host_idle_frac: float
    kv_util_mean: float
    kv_util_peak: float
    peak_active_requests: int
    prefix_hits: int
    preemptions: int           # requests swapped out under page exhaustion
    resumes: int               # swapped requests restored and continued
    policy_groups: int
    shards: int                # mesh serving-axis size (1 = single device)
    events: List[Dict[str, Any]]
    # speculative-decoding accounting (all zero when spec is off)
    spec_steps: int = 0        # batched verify steps launched
    spec_drafted: int = 0      # draft tokens proposed (rows x spec_k)
    spec_accepted: int = 0     # drafts accepted by the verify step
    spec_accept_rate: float = 0.0   # accepted / drafted
    spec_tokens_per_step: float = 0.0  # emitted per row-verify (incl. bonus)
    spec_disabled_groups: int = 0  # groups auto-disabled by the EWMA floor
    # launch accounting: group label -> steps its own model launched
    # (prefill + decode + verify), and -> draft steps launched for it
    group_steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    group_draft_steps: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def summary(self) -> str:
        lines = [
            f"requests {len(self.completed)}  generated "
            f"{self.generated_tokens} tok  wall {self.wall_s:.2f}s  "
            f"({self.tokens_per_s:.1f} tok/s decode)",
            f"prefill {self.prefill_s * 1e3:.1f} ms total;  decode step "
            f"p50 {self.step_p50_ms:.2f} / p99 {self.step_p99_ms:.2f} ms"
            f" over {self.decode_steps} steps"
            f" ({self.straggler_steps} stragglers)",
            f"TTFT p50 {self.ttft_p50_ms:.1f} / p95 {self.ttft_p95_ms:.1f} "
            f"/ p99 {self.ttft_p99_ms:.1f} ms;  request latency p50 "
            f"{self.latency_p50_ms:.1f} / p95 {self.latency_p95_ms:.1f} / "
            f"p99 {self.latency_p99_ms:.1f} ms",
            f"inter-token p50 {self.tok_lat_p50_ms:.2f} / p95 "
            f"{self.tok_lat_p95_ms:.2f} / p99 {self.tok_lat_p99_ms:.2f} ms",
            f"host idle {self.host_idle_s * 1e3:.1f} ms "
            f"({self.host_idle_frac * 100:.1f}% of wall) over {self.ticks} "
            f"ticks;  {self.shards} shard(s)",
            f"KV util mean {self.kv_util_mean * 100:.1f}% / peak "
            f"{self.kv_util_peak * 100:.1f}%;  peak concurrency "
            f"{self.peak_active_requests};  {self.prefix_hits} prefix-cache "
            f"block hit(s);  {self.policy_groups} policy group(s)",
            f"{self.preemptions} preemption(s) / {self.resumes} resume(s);  "
            f"{self.joined_mid_stream} request(s) joined the running batch "
            "mid-stream (continuous batching)",
        ]
        if self.spec_steps:
            lines.append(
                f"speculative: {self.spec_steps} verify step(s), "
                f"{self.spec_accepted}/{self.spec_drafted} drafts accepted "
                f"({self.spec_accept_rate * 100:.0f}%), "
                f"{self.spec_tokens_per_step:.2f} tokens/verify-step"
                + (f";  {self.spec_disabled_groups} group(s) auto-disabled"
                   if self.spec_disabled_groups else ""))
        return "\n".join(lines)


class _PolicyGroup:
    """One resolved approximation policy: a model rebound to that policy, a
    scheduler over ``num_slots`` decode rows, the per-row host-side
    metadata (block tables, last tokens) and its speculation state."""

    def __init__(self, label: str, policy: Optional[ApproxPolicy], model,
                 cfg: EngineConfig):
        self.label = label
        self.policy = policy
        self.model = model
        self.sched = Scheduler(cfg.num_slots)
        self.tables = np.full((cfg.num_slots, cfg.max_blocks_per_seq),
                              SENTINEL, np.int32)
        self.last_tok = np.zeros((cfg.num_slots,), np.int32)
        self.steps = 0        # steps its model launched (prefill/decode/verify)
        self.draft_steps = 0  # draft steps launched for its rows
        # speculative-decode state: eligibility (the engine disables groups
        # whose policy *is* the draft policy) and the dynamic-k controller's
        # acceptance EWMA (spec_on drops to False below the floor)
        self.spec_on = False
        self.spec_ewma: Optional[float] = None
        self.spec_obs = 0

    @property
    def prefill_rows(self) -> Dict[int, RequestState]:
        return {s: st for s, st in self.sched.active.items() if st.prefilling}

    @property
    def decode_rows(self) -> Dict[int, RequestState]:
        return {s: st for s, st in self.sched.active.items()
                if not st.prefilling}


def group_step(model, params, kv, tokens, tables, pos, last_idx, *,
               block_size: int) -> torch.Tensor:
    """One group's paged step: the argmax token at each row's last real
    position. Updates the KV pool ``kv`` in place (the reference donates it
    to a jit'd step instead) and returns without waiting for the card."""
    cache = dict(kv, block_tables=tables, pos=pos)
    logits, _ = model.paged_step(params, tokens, cache, block_size=block_size)
    idx = last_idx.long()[:, None, None].expand(-1, 1, logits.shape[-1])
    last = torch.gather(logits, 1, idx)  # (R, 1, V) at the true length
    return torch.argmax(last[:, 0, :], dim=-1)


class ServeEngine:
    """Drives a DecoderLM-style model (init_paged_cache / paged_step)
    through paged continuous-batching generation on ``device`` (default: the
    card; ``params`` must live there, whole), optionally sharded over
    ``mesh`` (tensor-parallel serving: a mesh with a ``model`` axis matching
    ``cfg.shards``; every rank of it builds this engine with the same
    arguments). ``run`` blocks until every submitted request completes."""

    # ticks with active/arrived work but no launches and no admissions
    # before the engine declares a livelock (undersized swap buffer)
    _STUCK_TICKS = 1000
    # dynamic-k controller: EWMA smoothing of the per-verify acceptance
    # rate, and how many verify steps to observe before the
    # ``spec_min_accept`` floor may disable a group's speculation
    _SPEC_EWMA_ALPHA = 0.4
    _SPEC_WARMUP = 4

    def __init__(self, model, params, cfg: EngineConfig, mesh=None,
                 device="cuda"):
        if not hasattr(model, "paged_step"):
            raise TypeError(
                f"{type(model).__name__} has no paged_step(); the serving "
                "engine requires the DecoderLM paged-cache API")
        if hasattr(model, "cfg"):
            cfg.validate_for_model(model.cfg)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model allocates on {model.device}, engine runs "
                             f"on {self.device}")
        for path, t in flatten(params).items():
            if t.device != self.device:
                raise ValueError(f"param {path} lies on {t.device}, engine "
                                 f"runs on {self.device}")
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self.shards = 1
        self.sharder = None
        if mesh is not None:
            from repro_torch.parallel.sharding import (Sharder, base_rules,
                                                       mesh_axis_names)

            names = mesh_axis_names(mesh)
            self.sharder = Sharder(mesh,
                                   base_rules("pod" in names, serve=True))
            if "model" in names:
                self.shards = self.sharder.size("model")
        if cfg.shards > 1 and self.shards != cfg.shards:
            have = (f"a {self.shards}-way 'model' axis" if mesh is not None
                    else "no mesh")
            raise ValueError(
                f"EngineConfig.shards={cfg.shards} but the engine got "
                f"{have}; pass ServeEngine(..., mesh=...) with a matching "
                "'model' mesh axis")
        if self.shards > 1 and (cfg.blocks % self.shards
                                or cfg.num_slots % self.shards):
            raise ValueError(
                f"EngineConfig: blocks={cfg.blocks} and num_slots="
                f"{cfg.num_slots} must both be divisible by the mesh "
                f"serving-axis size ({self.shards}): uneven banks make "
                "GSPMD silently replicate the pool instead of sharding it "
                "(daism-lint SRV007)")
        if self.sharder is not None:
            params = self._shard(model, params)
        self.params = params
        self.pool = BlockPool(cfg.blocks, cfg.block_size)
        with self._scope():
            self.kv = model.init_paged_cache(cfg.blocks, cfg.block_size)
        self._tiers: Dict[str, ApproxPolicy] = {
            name: parse_policy(spec, name=name) for name, spec in cfg.tiers}

        # self-speculative decoding: one draft model (the engine's weights
        # rebound to the cheap draft policy; it reads the same parameter
        # tensors) shared by every eligible group — the verify is per-group
        self._spec_key: Optional[ApproxPolicy] = None
        self._draft_model = None
        if cfg.spec_k:
            from repro_torch.models.registry import build_model

            draft_policy = self._resolve_policy(cfg.spec_draft)
            self._spec_key = dataclasses.replace(draft_policy, name="")
            self._draft_model = build_model(
                self.model.cfg.with_policy(draft_policy), device=self.device)

        self.groups: Dict[Optional[ApproxPolicy], _PolicyGroup] = {}
        self._pending_alloc: Dict[int, Tuple[List[int], int]] = {}
        self._next_id = 0
        self._swapped_blocks = 0

        self.step = 0
        self.events: List[Dict[str, Any]] = []
        self.watchdog = StepWatchdog()
        self._step_times: List[float] = []
        self._prefill_s = 0.0
        self._idle_s = 0.0
        self._tok_gaps: List[float] = []
        self._util_samples: List[float] = []
        self._util_peak = 0.0
        self._peak_active = 0
        self._preemptions = 0
        self._resumes = 0
        self._stuck_ticks = 0
        # speculative-decoding accounting
        self._spec_steps = 0       # batched verify launches
        self._spec_row_steps = 0   # (row, verify) pairs folded back
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_emitted = 0     # tokens emitted by verify (incl. bonus)
        self._spec_disabled = 0    # groups shut off by the EWMA floor

    # -- tensor parallelism ------------------------------------------------

    def _shard(self, model, params):
        """This rank's shards of ``params``, after the port-only layout
        checks (module doc)."""
        from repro_torch.models.convert import shard_params
        from repro_torch.models.layers import _paged_shard_axis

        s = self.sharder
        wide = {a: s.size(a) for a in s.axis_names
                if a != "model" and s.size(a) > 1}
        if wide:
            raise ValueError(
                f"tensor-parallel serving shards over the 'model' mesh axis "
                f"only; the mesh also splits {wide}")
        mc = model.cfg
        if self.shards > 1 and _paged_shard_axis(
                s, (1, 1, mc.n_heads, mc.head_dim),
                (1, mc.kv_heads, mc.head_dim)) != "model":
            raise ValueError(
                f"n_heads={mc.n_heads} and kv_heads={mc.kv_heads} must both "
                f"be divisible by the mesh serving-axis size ({self.shards}): "
                "the paged attention runs head-local on each rank's slice of "
                "the kv-head pool (serve with kv_heads a multiple of shards)")
        return shard_params(params, s, model=model)

    def _scope(self):
        """The engine's sharder as the ambient one (a no-op unsharded)."""
        from repro_torch.parallel.sharding import use_sharder

        return use_sharder(self.sharder)

    # -- numerics policy ---------------------------------------------------

    def resolution_report(self) -> str:
        """Per-site approximation resolution, one section per policy group
        (sites appear once a group's steps have run; see
        repro_torch.policy.site_report)."""
        from repro_torch.policy import site_report

        parts = []
        for group in self.groups.values():
            parts.append(f"== group {group.label} ==")
            parts.append(site_report(group.model.cfg.approx_policy))
        if not parts:
            parts = [site_report(self.model.cfg.approx_policy)]
        return "\n".join(parts)

    # -- request intake ----------------------------------------------------

    def _resolve_policy(self, policy) -> Optional[ApproxPolicy]:
        if policy is None or isinstance(policy, ApproxPolicy):
            return policy
        if isinstance(policy, str):
            if policy in self._tiers:
                return self._tiers[policy]
            if "=" in policy:
                return parse_policy(policy)
            raise ValueError(
                f"unknown policy tier {policy!r}: registered tiers are "
                f"{sorted(self._tiers)} (or pass a spec like '*=pc3_tr')")
        raise TypeError(
            f"Request.policy must be None, a tier name, a spec string, or "
            f"an ApproxPolicy (got {type(policy).__name__})")

    def _spec_eligible(self, key: Optional[ApproxPolicy]) -> bool:
        """Speculation is per-group: a group whose resolved policy *is* the
        draft policy would verify with the numerics it drafted with — a
        pure loss."""
        if self._spec_key is None:
            return False
        group_policy = key
        if group_policy is None:  # base group: the model's own policy
            group_policy = getattr(self.model.cfg, "approx_policy", None)
        if group_policy is None:
            return True
        return dataclasses.replace(group_policy, name="") != self._spec_key

    def _group_for(self, policy: Optional[ApproxPolicy]) -> _PolicyGroup:
        # the group key ignores the policy's display name: a tier name and
        # the equivalent raw spec share one group and one prefix cache
        key = (None if policy is None
               else dataclasses.replace(policy, name=""))
        group = self.groups.get(key)
        if group is None:
            if policy is None:
                label, model = "base", self.model
            else:
                from repro_torch.models.registry import build_model

                label = policy.name or f"policy_{len(self.groups)}"
                model = build_model(self.model.cfg.with_policy(policy),
                                    device=self.device)
            group = _PolicyGroup(label, key, model, self.cfg)
            group.spec_on = self._spec_eligible(key)
            self.groups[key] = group
        return group

    def submit(self, request: Request) -> RequestState:
        if not request.prompt:
            raise ValueError("prompt must be non-empty")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "yields the first token)")
        need = len(request.prompt) + request.max_new_tokens
        if need > self.cfg.max_seq:
            raise ValueError(
                f"request needs {need} cache positions > max_seq "
                f"{self.cfg.max_seq}")
        group = self._group_for(self._resolve_policy(request.policy))
        state = group.sched.submit(request, now=time.perf_counter())
        state.request_id = self._next_id  # engine-global, not per-group
        self._next_id += 1
        state.group = group.label
        if state.eos_id is None:  # engine default; the Request is not mutated
            state.eos_id = self.cfg.eos_id
        return state

    # -- engine internals --------------------------------------------------

    def _event(self, kind: str, state: RequestState, slot: int, **kw):
        self.events.append(dict(step=self.step, event=kind,
                                request_id=state.request_id,
                                slot=slot, group=state.group, **kw))

    def _try_reserve(self, group: _PolicyGroup, state: RequestState,
                     allow_preempt: bool = False) -> bool:
        """Admission gate. Reservation depends on the engine mode: whole
        lifetime (prompt + gen - 1; an admitted request can always finish)
        by default, prompt-only when preemption is on (optimistic — decode
        extends on demand and swaps victims out under exhaustion),
        written-length for a resuming swapped request. With
        ``allow_preempt``, strictly-lower-priority running requests are
        swapped out to make room."""
        req = state.request
        if state.swap is not None:
            total = state.seq_len        # resume: cover what was written
        elif self.cfg.preempt:
            total = len(req.prompt)      # optimistic: prompt only
        else:
            total = len(req.prompt) + req.max_new_tokens - 1
        args = (state.request_id, req.prompt, max(total, 1))
        alloc = self.pool.allocate(*args, policy_key=group.policy)
        while alloc is None and allow_preempt:
            victim = self._pick_victim(exclude_id=state.request_id,
                                       max_priority=req.priority)
            if victim is None:
                break
            self._preempt(*victim)
            alloc = self.pool.allocate(*args, policy_key=group.policy)
        if alloc is None:
            return False
        self._pending_alloc[state.request_id] = alloc
        return True

    def _admit(self, group: _PolicyGroup, admitted: List[RequestState]):
        for state in admitted:
            table, cached_len = self._pending_alloc.pop(state.request_id)
            group.tables[state.slot] = SENTINEL
            group.tables[state.slot, :len(table)] = table
            if state.swap is not None:
                self._swap_restore(group, state, table)
                continue
            state.next_pos = cached_len
            state.cached_len = cached_len
            state.admit_time = time.perf_counter()
            self._event("admit", state, state.slot,
                        joined_running=state.joined_running_batch,
                        blocks=len(table),
                        cached_blocks=cached_len // self.cfg.block_size)

    # -- preemption / swap -------------------------------------------------

    def _pick_victim(self, exclude_id: Optional[int] = None,
                     max_priority: Optional[int] = None):
        """Lowest-priority (tie: youngest admission) *decoding* request
        whose pages fit in the remaining swap buffer. Prefilling rows are
        never preempted — their pages are mid-write. Returns
        ``(group, slot, state)`` or None."""
        best = None
        free_swap = self.cfg.swap_capacity - self._swapped_blocks
        for group in self.groups.values():
            for slot, st in group.sched.active.items():
                if st.prefilling or st.request_id == exclude_id:
                    continue
                if (max_priority is not None
                        and st.request.priority >= max_priority):
                    continue
                if blocks_needed(st.seq_len,
                                 self.cfg.block_size) > free_swap:
                    continue
                key = (st.request.priority, -st.admit_step, -st.request_id)
                if best is None or key < best[0]:
                    best = (key, group, slot, st)
        return None if best is None else best[1:]

    def _swap_idx(self, table: np.ndarray) -> torch.Tensor:
        """Physical cells of a (MB,) SENTINEL-padded table, page by page;
        every cell of an unmapped page is the sink cell (index ``cells``)."""
        cells = self.kv["k"].shape[1] - 1
        bs = self.cfg.block_size
        t = torch.from_numpy(table).to(self.device).long()
        base = torch.where(t < 0, cells, t * bs)
        return (base[:, None] + torch.arange(bs, device=self.device)
                ).reshape(-1).clamp(max=cells)

    def _preempt(self, group: _PolicyGroup, slot: int, state: RequestState):
        """Swap ``state`` out: exact gather of its written pages into a host
        buffer (the copy waits for the card: part of the preemption's
        cost), then free its blocks and decode row."""
        n_blocks = blocks_needed(state.seq_len, self.cfg.block_size)
        table = np.full((self.cfg.max_blocks_per_seq,), SENTINEL, np.int32)
        table[:n_blocks] = group.tables[slot, :n_blocks]
        cells = self.kv["k"].shape[1] - 1
        with trace.span("engine.swap", blocks=n_blocks):
            idx = self._swap_idx(table).clamp(max=cells - 1)
            with torch.inference_mode():
                state.swap = {"k": self.kv["k"][:, idx].cpu(),
                              "v": self.kv["v"][:, idx].cpu(),
                              "blocks": n_blocks}
        self._swapped_blocks += n_blocks
        self.pool.free(state.request_id)
        group.sched.requeue(slot)
        group.tables[slot] = SENTINEL
        self._preemptions += 1
        self._event("preempt", state, slot, blocks=n_blocks)

    def _swap_restore(self, group: _PolicyGroup, state: RequestState,
                      table: List[int]):
        """Scatter a resuming request's swapped pages through its fresh
        block table — bit-exact restore, so greedy decode continues
        token-identically from its last emitted token."""
        swap, state.swap = state.swap, None
        n_old = swap["blocks"]
        self._swapped_blocks -= n_old
        # only the written blocks are restored; any extra freshly-allocated
        # blocks cover future positions and are written by decode itself.
        # Unmapped entries land in the sink cell, never in a real page.
        t = np.full((self.cfg.max_blocks_per_seq,), SENTINEL, np.int32)
        t[:n_old] = table[:n_old]
        with trace.span("engine.swap", blocks=n_old):
            idx = self._swap_idx(t)
            with torch.inference_mode():
                for name in ("k", "v"):
                    self.kv[name].index_copy_(1, idx,
                                              swap[name].to(self.device))
        self.pool.advance(state.request_id, state.seq_len)
        self.pool.commit_prefix(state.request_id)
        group.last_tok[state.slot] = state.output[-1]
        self._resumes += 1
        self._event("resume", state, state.slot, blocks=len(table))

    def _ensure_blocks(self, group: _PolicyGroup, state: RequestState,
                       ahead: int = 0) -> bool:
        """Grow the row's table to cover its next token write (a no-op
        inside the reservation); under preemption, swap victims out on
        exhaustion. False = the row stalls this tick (no decode step).

        ``ahead`` asks for extra speculative coverage (the draft window
        past the next write). It is best-effort and never evicts anyone:
        if the pool can't cover it, the row falls back to plain
        single-token growth — the verify caps acceptance at whatever
        coverage the row actually got — and only *that* baseline need may
        preempt victims."""
        if ahead:
            table = self.pool.extend(state.request_id,
                                     state.seq_len + 1 + ahead)
            if table is not None:
                group.tables[state.slot, :len(table)] = table
                return True
        need = state.seq_len + 1
        table = self.pool.extend(state.request_id, need)
        while table is None and self.cfg.preempt:
            victim = self._pick_victim(exclude_id=state.request_id)
            if victim is None:
                return False
            self._preempt(*victim)
            table = self.pool.extend(state.request_id, need)
        if table is None:
            return False
        group.tables[state.slot, :len(table)] = table
        return True

    # -- token bookkeeping -------------------------------------------------

    def _append_token(self, group: _PolicyGroup, state: RequestState,
                      token: int):
        now = time.perf_counter()
        if state.last_token_time:
            gap = now - state.last_token_time
            state.token_gaps_s.append(gap)
            self._tok_gaps.append(gap)
        state.last_token_time = now
        state.output.append(token)
        group.last_tok[state.slot] = token
        reason = ""
        if state.eos_id is not None and token == state.eos_id:
            reason = "eos"
        elif len(state.output) >= state.request.max_new_tokens:
            reason = "length"
        if reason:
            slot = state.slot  # retire() resets it; event wants the real one
            group.sched.retire(slot, reason, self.step, now=now)
            group.tables[slot] = SENTINEL
            self.pool.free(state.request_id)
            self._event("retire", state, slot, reason=reason)

    # -- launch / fetch / apply (async tick phases) --------------------------

    def _to_device(self, arr: np.ndarray, keep: list) -> torch.Tensor:
        """Host array -> device tensor without blocking the host: pinned
        staging + non-blocking copy on CUDA. ``keep`` holds the staging
        buffer until the record is fetched."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        t = t.pin_memory()
        keep.append(t)
        return t.to(self.device, non_blocking=True)

    def _launch_span(self, group: _PolicyGroup, kind: str, rows,
                     positions: int, tokens: int):
        """The ``engine.launch`` span of one group step; its start is the
        step clock's (``_fetch``)."""
        return trace.timed(
            "engine.launch", counters=trace.kernel_launches, kind=kind,
            group=group.label,
            request_ids=[st.request_id for st in rows.values()],
            positions=positions, tokens=tokens)

    def _launch(self, group: _PolicyGroup, tokens, tables, pos, last_idx):
        keep: list = []
        with torch.inference_mode(), self._scope():
            with trace.span("engine.stage"):
                staged = (self._to_device(tokens, keep).long(),
                          self._to_device(tables, keep),
                          self._to_device(pos, keep),
                          self._to_device(last_idx, keep))
            tok = group_step(group.model, self.params, self.kv, *staged,
                             block_size=self.cfg.block_size)
        group.steps += 1
        return tok, keep

    def _launch_prefill(self, group: _PolicyGroup) -> Optional[dict]:
        """Launch one prefill chunk for every row of ``group`` still
        ingesting its prompt; rows reaching the last prompt token emit their
        first generated token at apply time. Decode rows are masked out
        (sentinel tables) so their K/V is untouched."""
        rows = group.prefill_rows
        if not rows:
            return None
        cfg = self.cfg
        chunk = cfg.prefill_chunk
        r = cfg.num_slots
        tokens = np.zeros((r, chunk), np.int32)
        tables = np.full_like(group.tables, SENTINEL)
        pos = np.zeros((r,), np.int32)
        last_idx = np.zeros((r,), np.int32)
        finishing: Set[int] = set()
        real = 0
        for slot, state in rows.items():
            prompt = state.request.prompt
            piece = prompt[state.next_pos:state.next_pos + chunk]
            tokens[slot, :len(piece)] = piece
            tables[slot] = group.tables[slot]
            pos[slot] = state.next_pos
            last_idx[slot] = len(piece) - 1
            if state.next_pos + len(piece) == len(prompt):
                finishing.add(slot)
            state.next_pos += len(piece)
            real += len(piece)
        with self._launch_span(group, "prefill", rows, tokens.size,
                               real) as sp:
            tok, keep = self._launch(group, tokens, tables, pos, last_idx)
        return {"group": group, "kind": "prefill", "rows": rows,
                "finishing": finishing, "tok": tok, "keep": keep,
                "t0": sp.start_ns}

    def _decode_inputs(self, group: _PolicyGroup, stalled: Set[int]):
        """(rows, tables, pos) of ``group``'s generating rows that are not
        stalled this tick; other rows keep sentinel tables (masked out)."""
        rows = {s: st for s, st in group.decode_rows.items()
                if st.request_id not in stalled}
        tables = np.full_like(group.tables, SENTINEL)
        pos = np.zeros((self.cfg.num_slots,), np.int32)
        for slot, state in rows.items():
            tables[slot] = group.tables[slot]
            pos[slot] = state.seq_len  # write position of the fed-back token
        return rows, tables, pos

    def _launch_decode(self, group: _PolicyGroup,
                       stalled: Set[int]) -> Optional[dict]:
        """Launch one decode token for every generating row of ``group``;
        prefill, stalled and idle rows are masked out."""
        rows, tables, pos = self._decode_inputs(group, stalled)
        if not rows:
            return None
        with self._launch_span(group, "decode", rows, self.cfg.num_slots,
                               len(rows)) as sp:
            tok, keep = self._launch(group, group.last_tok[:, None].copy(),
                                     tables, pos,
                                     np.zeros((self.cfg.num_slots,),
                                              np.int32))
        return {"group": group, "kind": "decode", "rows": rows,
                "tok": tok, "keep": keep, "t0": sp.start_ns}

    def _launch_spec(self, group: _PolicyGroup,
                     stalled: Set[int]) -> Optional[dict]:
        """Speculative decode for ``group``'s generating rows: chain
        ``spec_k`` S=1 draft steps (draft-policy model, same pages — the
        drafted K/V is scratch the verify step overwrites in place), then
        launch the batched S=spec_k+1 verify under the group's own policy.
        All ``spec_k + 1`` steps go out without a host wait; the
        accept/reject fold happens at apply time from one fetched
        ``(greedy, n_acc)`` pair.

        Each row's acceptance is capped by its actual page coverage
        (``caps``): when the speculative ``extend`` failed, candidate
        positions past the mapped pages saw dropped writes/stale reads,
        so only the in-coverage prefix — whose attention window is fully
        mapped — is trusted. Positions ``<= cap`` attend only mapped,
        exactly-written K/V, so the accepted tokens are exact."""
        rows, tables, pos = self._decode_inputs(group, stalled)
        if not rows:
            return None
        cfg = self.cfg
        caps: Dict[int, int] = {}
        for slot, state in rows.items():
            cov = int((group.tables[slot] != SENTINEL).sum()) * cfg.block_size
            caps[slot] = max(0, cov - 1 - state.seq_len)
        keep: list = []
        window = cfg.spec_k + 1
        with self._launch_span(group, "spec", rows, cfg.num_slots * window,
                               len(rows) * window) as sp, \
                torch.inference_mode(), self._scope():
            with trace.span("engine.stage"):
                jt = self._to_device(tables, keep)
                jp = self._to_device(pos, keep)
                zero = torch.zeros_like(jp)
                toks = [self._to_device(group.last_tok, keep).long()]
            for j in range(cfg.spec_k):
                toks.append(group_step(
                    self._draft_model, self.params, self.kv,
                    toks[-1][:, None], jt, jp + j, zero,
                    block_size=cfg.block_size))
            cand = torch.stack(toks, dim=1)  # (R, spec_k+1) candidate window
            greedy, n_acc, _ = group.model.paged_verify_step(
                self.params, cand, dict(self.kv, block_tables=jt, pos=jp),
                block_size=cfg.block_size)
        group.draft_steps += cfg.spec_k
        group.steps += 1
        return {"group": group, "kind": "spec", "rows": rows, "tok": greedy,
                "n_acc": n_acc, "caps": caps, "keep": keep,
                "t0": sp.start_ns}

    def _fetch(self, rec: dict):
        """Wait for a launched step's tokens: the only host wait in the
        loop; the waiting time is the tick's idle accounting. The step time
        runs from the ``engine.launch`` span's start to this span's end."""
        if "np_tok" in rec:
            return
        with trace.timed("engine.fetch") as sp:
            rec["np_tok"] = rec.pop("tok").cpu().numpy()
            if "n_acc" in rec:
                rec["np_acc"] = rec.pop("n_acc").cpu().numpy()
            rec.pop("keep")
        self._idle_s += (sp.end_ns - sp.start_ns) / 1e9
        rec["dt"] = (sp.end_ns - rec["t0"]) / 1e9

    def _apply(self, rec: dict):
        """Fold a fetched step's tokens back into scheduler/pool state."""
        group, rows, tok = rec["group"], rec["rows"], rec["np_tok"]
        dt = rec["dt"]
        if rec["kind"] == "prefill":
            self._prefill_s += dt
            now = time.perf_counter()
            for slot, state in rows.items():
                state.prefill_s += dt
                if slot in rec["finishing"]:
                    state.first_token_time = now
                    self.pool.commit_prefix(state.request_id)
                    self._append_token(group, state, int(tok[slot]))
                if state.request_id in self.pool:
                    self.pool.advance(state.request_id, state.seq_len)
        elif rec["kind"] == "spec":
            self._step_times.append(dt)
            self.watchdog.observe(dt)
            k = self.cfg.spec_k
            rates = []
            self._spec_steps += 1
            for slot, state in list(rows.items()):
                greedy = tok[slot]
                raw = int(rec["np_acc"][slot])      # draft-quality signal
                n_acc = min(raw, rec["caps"][slot])  # coverage-capped
                emitted = 0
                for j in range(n_acc + 1):
                    self._append_token(group, state, int(greedy[j]))
                    emitted += 1
                    if state.slot < 0:  # retired (eos / length): exact
                        break           # decode would have stopped here too
                self._spec_row_steps += 1
                self._spec_drafted += k
                self._spec_accepted += emitted - 1
                self._spec_emitted += emitted
                state.spec_drafted += k
                state.spec_accepted += emitted - 1
                rates.append(min(raw, k) / k)
                if state.request_id in self.pool:
                    self.pool.advance(state.request_id, state.seq_len)
                    if self.cfg.preempt:
                        # roll the speculative reservation back: pages
                        # covering only rejected positions return to the
                        # pool; the partially-kept page's stale cells are
                        # overwritten by the next window
                        freed = self.pool.truncate(state.request_id,
                                                   state.seq_len)
                        if freed:
                            row = group.tables[state.slot]
                            mapped = int((row != SENTINEL).sum())
                            row[mapped - freed:] = SENTINEL
            self._update_spec_controller(group, rates)
        else:
            self._step_times.append(dt)
            self.watchdog.observe(dt)
            for slot, state in list(rows.items()):
                self._append_token(group, state, int(tok[slot]))
                if state.request_id in self.pool:
                    self.pool.advance(state.request_id, state.seq_len)

    def _update_spec_controller(self, group: _PolicyGroup,
                                rates: List[float]):
        """Dynamic-k controller: EWMA the verify acceptance rate and shut a
        group's speculation off (plain decode) once the warmed-up average
        sinks below ``spec_min_accept``. Token identity never depends on
        the controller: a disabled group just takes the S=1 path."""
        if not rates:
            return
        rate = float(np.mean(rates))
        a = self._SPEC_EWMA_ALPHA
        group.spec_ewma = (rate if group.spec_ewma is None
                           else a * rate + (1 - a) * group.spec_ewma)
        group.spec_obs += 1
        if (group.spec_obs >= self._SPEC_WARMUP
                and group.spec_ewma < self.cfg.spec_min_accept):
            group.spec_on = False
            self._spec_disabled += 1
            self.events.append(dict(
                step=self.step, event="spec_off", request_id=-1, slot=-1,
                group=group.label, ewma=round(group.spec_ewma, 3)))

    # -- tick loop -----------------------------------------------------------

    def _stamp_arrivals(self, now: float):
        for group in self.groups.values():
            for waiting in group.sched.waiting:  # trace replay: stamp arrival
                if (waiting.arrival_time == 0.0
                        and waiting.request.arrival_step <= self.step):
                    waiting.arrival_time = now

    def _admit_all(self, allow_preempt: bool) -> bool:
        any_admitted = False
        for group in self.groups.values():
            admitted = group.sched.admit(
                self.step,
                can_admit=lambda st, g=group: self._try_reserve(
                    g, st, allow_preempt))
            if admitted:
                self._admit(group, admitted)
                any_admitted = True
        return any_admitted

    def _sample_util(self):
        active = sum(len(g.sched.active) for g in self.groups.values())
        if active:
            util = self.pool.utilization()["pool_util"]
            self._util_samples.append(util)
            self._util_peak = max(self._util_peak, util)

    def tick(self) -> bool:
        """One engine iteration, in phases:

        0. grow decode tables for this tick's writes (may preempt/swap);
        1. *launch* every group's prefill chunk + decode (or speculative)
           step without waiting (``overlap=False``: fetch right after each
           launch);
        2. host work while the card runs: arrival stamping, admission +
           page reservation, utilization sampling;
        3. token fetch, then fold tokens into scheduler state;
        4. post-retirement admission (pages just freed; preemption/resume
           allowed here).

        Returns False when fully drained."""
        if not any(g.sched.has_work for g in self.groups.values()):
            return False
        with trace.span("engine.tick", step=self.step):
            return self._phases()

    def _phases(self) -> bool:
        """``tick``'s phases, each under its span."""
        stalled: Set[int] = set()
        with trace.span("engine.blocks"):
            for group in self.groups.values():
                # speculative rows want spec_k extra positions of coverage,
                # but only in preempt mode (on-demand growth + truncate
                # rollback); a whole-lifetime reservation already covers
                # every position acceptance can reach
                ahead = (self.cfg.spec_k
                         if group.spec_on and self.cfg.preempt else 0)
                for _slot, state in list(group.decode_rows.items()):
                    if state.request_id not in self.pool:
                        continue  # preempted as a victim earlier this phase
                    if not self._ensure_blocks(group, state, ahead=ahead):
                        stalled.add(state.request_id)
        inflight = []
        for phase in ("prefill", "decode"):
            for group in self.groups.values():
                if phase == "prefill":
                    rec = self._launch_prefill(group)
                elif group.spec_on:
                    rec = self._launch_spec(group, stalled)
                else:
                    rec = self._launch_decode(group, stalled)
                if rec is not None:
                    inflight.append(rec)
                    if not self.cfg.overlap:
                        self._fetch(rec)
        with trace.span("engine.admit"):
            self._stamp_arrivals(time.perf_counter())
            admitted = self._admit_all(allow_preempt=False)
            self._sample_util()
        for rec in inflight:
            # fetch+apply interleaved: an earlier record's host bookkeeping
            # runs while later records are still computing on the card
            self._fetch(rec)
            with trace.span("engine.apply"):
                self._apply(rec)
        with trace.span("engine.admit"):
            admitted |= self._admit_all(allow_preempt=self.cfg.preempt)
        self._peak_active = max(
            self._peak_active,
            sum(len(g.sched.active) for g in self.groups.values()))
        arrived_waiting = any(
            st.request.arrival_step <= self.step
            for g in self.groups.values() for st in g.sched.waiting)
        if inflight or admitted or not arrived_waiting:
            self._stuck_ticks = 0
        else:
            self._stuck_ticks += 1
            if self._stuck_ticks >= self._STUCK_TICKS:
                raise RuntimeError(
                    f"serving livelock: {self._stuck_ticks} ticks with "
                    "waiting work but no progress — the KV pool and swap "
                    "buffer together cannot host any runnable request "
                    "(undersized swap_blocks?)")
        self.step += 1
        return any(g.sched.has_work for g in self.groups.values())

    # -- driver ------------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> ServeReport:
        """Serve ``requests`` to completion and report. Single-use: build a
        fresh engine for another run."""
        if self._step_times or any(g.sched.finished
                                   for g in self.groups.values()):
            raise RuntimeError(
                "ServeEngine.run() is single-use; build a fresh engine")
        for r in requests:
            self.submit(r)
        t0 = time.perf_counter()
        while self.tick():
            pass
        wall = time.perf_counter() - t0
        done = [s for g in self.groups.values() for s in g.sched.finished]
        done.sort(key=lambda s: s.request_id)
        generated = sum(len(s.output) for s in done)
        decode_s = float(sum(self._step_times))
        # prefill produces 1 token/request; the rest ride decode steps
        decode_tokens = generated - len(done)
        gaps_ms = [g * 1e3 for g in self._tok_gaps]
        return ServeReport(
            completed=done,
            wall_s=wall,
            prefill_s=self._prefill_s,
            decode_s=decode_s,
            decode_steps=len(self._step_times),
            generated_tokens=generated,
            tokens_per_s=decode_tokens / decode_s if decode_s else 0.0,
            ttft_p50_ms=_pct([s.ttft_s * 1e3 for s in done], 50),
            ttft_p95_ms=_pct([s.ttft_s * 1e3 for s in done], 95),
            ttft_p99_ms=_pct([s.ttft_s * 1e3 for s in done], 99),
            latency_p50_ms=_pct([s.latency_s * 1e3 for s in done], 50),
            latency_p95_ms=_pct([s.latency_s * 1e3 for s in done], 95),
            latency_p99_ms=_pct([s.latency_s * 1e3 for s in done], 99),
            tok_lat_p50_ms=_pct(gaps_ms, 50),
            tok_lat_p95_ms=_pct(gaps_ms, 95),
            tok_lat_p99_ms=_pct(gaps_ms, 99),
            step_p50_ms=_pct([t * 1e3 for t in self._step_times], 50),
            step_p99_ms=_pct([t * 1e3 for t in self._step_times], 99),
            joined_mid_stream=sum(s.joined_running_batch for s in done),
            straggler_steps=self.watchdog.stragglers,
            ticks=self.step,
            host_idle_s=self._idle_s,
            host_idle_frac=self._idle_s / wall if wall else 0.0,
            kv_util_mean=(float(np.mean(self._util_samples))
                          if self._util_samples else 0.0),
            kv_util_peak=self._util_peak,
            peak_active_requests=self._peak_active,
            prefix_hits=self.pool.prefix_hits,
            preemptions=self._preemptions,
            resumes=self._resumes,
            policy_groups=len(self.groups),
            shards=self.shards,
            events=self.events,
            spec_steps=self._spec_steps,
            spec_drafted=self._spec_drafted,
            spec_accepted=self._spec_accepted,
            spec_accept_rate=(self._spec_accepted / self._spec_drafted
                              if self._spec_drafted else 0.0),
            spec_tokens_per_step=(self._spec_emitted / self._spec_row_steps
                                  if self._spec_row_steps else 0.0),
            spec_disabled_groups=self._spec_disabled,
            group_steps={g.label: g.steps for g in self.groups.values()},
            group_draft_steps={g.label: g.draft_steps
                               for g in self.groups.values()},
        )
