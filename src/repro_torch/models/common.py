"""Architecture configuration shared by the whole model zoo."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.config import Backend, DaismConfig, Variant
from repro_torch.policy import ApproxPolicy, parse_policy, validate_for_dtype

EXACT = DaismConfig(variant=Variant.EXACT, backend=Backend.EXACT)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (frozen + hashable), field for field the
    JAX package's ``ArchConfig``."""

    name: str
    family: str               # dense | moe | vlm | ssm | audio | hybrid | cnn
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"       # swiglu | geglu | relu2 | gelu
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # --- MoE ---
    n_experts: int = 0
    topk: int = 0
    expert_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "ep"      # ep (shard_map) | dense (reference)
    # --- VLM ---
    cross_every: int = 0      # a cross-attn block after every N self blocks
    n_image_tokens: int = 0
    # --- SSM / hybrid / xLSTM ---
    ssm_state: int = 0
    d_inner: int = 0
    ssm_heads: int = 0
    conv_kernel: int = 4
    shared_attn_every: int = 0   # zamba2: shared attn block cadence
    slstm_every: int = 0         # xlstm: 1 sLSTM per N blocks
    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 0
    # --- attention ---
    window: int = 0           # sliding window; 0 = full causal
    attn_chunk: int = 1024    # online-softmax KV chunk length
    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_score_dtype: str = "float32"   # bfloat16 halves attention traffic
    rnn_state_dtype: str = "float32"
    # DEPRECATED: one global config for every GEMM. Kept as a shim — when
    # ``policy`` is unset it is wrapped into a uniform one-rule policy by
    # ``approx_policy``. New code should set ``policy`` instead.
    daism: DaismConfig = EXACT
    # Per-site approximation policy (repro.policy). Takes precedence over
    # ``daism`` when set.
    policy: Optional[ApproxPolicy] = None
    # activation checkpointing of each layer in a training forward
    # (models/transformer.py::apply_remat)
    remat: str = "none"       # none | dots | dots_nb | full
    scan_layers: bool = True

    def __post_init__(self) -> None:
        if self.remat not in ("none", "dots", "dots_nb", "full"):
            raise ValueError(f"{self.name}: remat={self.remat!r}: one of "
                             "none, dots, dots_nb, full")
        # fail at construction, not deep inside a kernel trace: every config
        # a site can resolve to must be runnable on the compute dtype
        for where, dcfg in self._numerics_configs():
            validate_for_dtype(dcfg, self.compute_dtype, site=where)

    def _numerics_configs(self):
        if self.policy is not None:
            for r in self.policy.rules:
                yield f"{self.name}:policy[{r.pattern}]", r.config
            yield f"{self.name}:policy[default]", self.policy.default
        else:
            yield f"{self.name}:daism", self.daism

    @property
    def approx_policy(self) -> ApproxPolicy:
        """The effective policy: ``policy`` if set, else the deprecation shim
        wrapping the legacy ``daism`` field as a uniform one-rule policy."""
        if self.policy is not None:
            return self.policy
        return ApproxPolicy.uniform(self.daism)

    def with_policy(self, policy) -> "ArchConfig":
        """Return a copy using ``policy`` (an ApproxPolicy or a spec string
        like ``"*/attn/*=exact,*=pc3_tr"``)."""
        if isinstance(policy, str):
            policy = parse_policy(policy)
        return dataclasses.replace(self, policy=policy)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def smoke(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, min(self.n_layers, 2 + (self.shared_attn_every > 0))),
            d_model=64,
            n_heads=4,
            kv_heads=max(1, min(self.kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            expert_ff=64 if self.expert_ff else 0,
            d_inner=128 if self.d_inner else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            cross_every=2 if self.cross_every else 0,
            n_image_tokens=8 if self.n_image_tokens else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_frames=16 if self.enc_frames else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            window=min(self.window, 32) if self.window else 0,
            attn_chunk=16,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
