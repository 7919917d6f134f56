"""Mixture-of-Experts FFN on one device: every expert on every token,
gate-weighted (the JAX package's ``_dense_moe``).

On one device the reference takes its dense implementation whatever
``moe_impl`` says (it has no sharder to lay experts out), and so does the
port. The expert-parallel path (``_local_dispatch_compute``, ``_capacity``,
the ``shard_map`` branch) is multi-device work, not ported yet.

Two choices make a token's result independent of how many tokens share
its call (M), so that a paged serving step, a slot-cache decode step and a
full forward route every token alike:

* the router's f32 logits are computed in blocks of :data:`ROUTER_ROWS`
  rows (the last block zero-padded), so every row goes through one GEMM
  shape whatever M is; a library GEMM picks its algorithm, and with it the
  summation order, by shape;
* the top-k is an explicit stable sort (the lower expert id first among
  equal probabilities, as ``lax.top_k`` orders ties), and the combine adds
  each token's k gated expert outputs one after another, in f32, instead of
  a contraction over all experts.

The expert GEMMs go through :func:`repro_torch.policy.policy_expert_matmul`
(one kernel launch a site for all the experts; the tokens reach it as a
broadcast view, never copied E times).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.policy import policy_expert_matmul

from .common import ArchConfig
from .layers import activate
from .module import Ctx

ROUTER_ROWS = 128  # the rows of the router's one GEMM shape


def _expert_mm(x: torch.Tensor, w: torch.Tensor, cfg: ArchConfig,
               name: str) -> torch.Tensor:
    """(E, C, d) x (E, d, f) -> (E, C, f), per-site DAISM via the policy."""
    return policy_expert_matmul(cfg.approx_policy, x, w, name=name)


def router_logits(x2d: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """f32 ``x2d @ router_w``, (T, d) @ (d, E) -> (T, E), through one GEMM
    shape (:data:`ROUTER_ROWS`, d) @ (d, E) whatever T is, so a row's
    logits do not depend on the rows beside it."""
    x = x2d.to(torch.float32)
    w = router_w.to(torch.float32)
    t = x.shape[0]
    pad = (-t) % ROUTER_ROWS
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return torch.cat([x[i:i + ROUTER_ROWS] @ w
                      for i in range(0, x.shape[0], ROUTER_ROWS)])[:t]


def _route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig):
    """Token-choice top-k. Returns (ids (T,k), probs (T,k), aux_loss)."""
    probs_full = torch.softmax(router_logits(x2d, router_w), dim=-1)  # (T, E)
    top, order = torch.sort(probs_full, dim=-1, descending=True, stable=True)
    probs, ids = top[:, :cfg.topk], order[:, :cfg.topk]
    probs = probs / probs.sum(-1, keepdim=True)
    # Switch-style load-balance auxiliary loss
    me = probs_full.mean(0)                                       # (E,)
    flat = ids.reshape(-1)
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32,
                     device=x2d.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            dtype=torch.float32, device=x2d.device))
    aux = cfg.n_experts * torch.sum(me * ce)
    return ids, probs, aux


def _dense_moe(x, router_w, w_in, w_gate, w_out, cfg: ArchConfig):
    """All experts on all tokens, top-k gate-weighted. The broadcast
    (E, T, d) operand is a view (stride 0 over the experts)."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    ids, probs, aux = _route(x2d, router_w, cfg)
    xb = x2d[None].expand(cfg.n_experts, t, d)
    h = _expert_mm(xb, w_in, cfg, "w_in")                         # (E, T, f)
    g = _expert_mm(xb, w_gate, cfg, "w_gate") if w_gate is not None else None
    h = activate(h, g, cfg.act)
    y = _expert_mm(h, w_out, cfg, "w_out")                        # (E, T, d)
    # out[t] = sum_j probs[t, j] y[ids[t, j], t], in f32: the reference's
    # einsum over all experts with the unselected gates 0
    rows = torch.arange(t, device=x.device)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(cfg.topk):
        out = out + y[ids[:, j], rows].to(torch.float32) * probs[:, j, None]
    return out.to(x.dtype).reshape(b, s, d), aux


def moe_ffn(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: (B, S, d). Returns (out, aux_loss). Parameters
    ``router`` (d, E) f32, ``w_in``/``w_gate`` (E, d, expert_ff) and
    ``w_out`` (E, expert_ff, d); ``w_gate`` only for gated activations."""
    gated = cfg.act in ("swiglu", "geglu")
    return _dense_moe(x, ctx.param("router"), ctx.param("w_in"),
                      ctx.param("w_gate") if gated else None,
                      ctx.param("w_out"), cfg)
