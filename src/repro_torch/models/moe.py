"""Mixture-of-Experts FFN: the dense every-expert path and expert
parallelism (EP), ported from ``repro/models/moe.py``.

* ``dense``: every expert on every token, gate-weighted (the reference's
  ``_dense_moe``). It runs without a sharder, whatever ``moe_impl`` says
  (the reference has no mesh to lay experts out then either), and under a
  sharder when the EP rule below does not hold (the expert weights are
  then gathered whole first).
* ``ep``: under a sharder with a ``model`` axis that divides the experts
  (and batch, d and expert_ff divisible by the data(+pod) size: the
  reference's ``use_ep`` rule, word for word). Each model rank holds the
  experts ``[e0, e0 + E/n)``; the contraction dim of their weights, sharded
  over the data axes, is all-gathered just in time. The rank routes its
  tokens, dispatches those that chose its experts into a static capacity
  buffer (Switch-style token dropping: a slot past ``_capacity`` goes to a
  trash row and its token gets no output from that expert), runs the
  expert GEMMs at (E/n, capacity, d, f) and combines by the gates; the
  partial outputs are summed over ``model`` and ``aux`` is averaged.
  Under the serve rules ``x`` is whole on every data rank, which keeps its
  rows and gathers the output back; under the train rules (``act_batch``
  over the data axes) ``x`` is already this rank's rows, and capacity is
  counted per data shard, as the reference's ``shard_map`` counts it.

Two choices make a token's result independent of how many tokens share
its call (M), so that a paged serving step, a slot-cache decode step and a
full forward route every token alike:

* the router's f32 logits are computed in blocks of :data:`ROUTER_ROWS`
  rows (the last block zero-padded), so every row goes through one GEMM
  shape whatever M is; a library GEMM picks its algorithm, and with it the
  summation order, by shape;
* the top-k is an explicit stable sort (the lower expert id first among
  equal probabilities, as ``lax.top_k`` orders ties), and the dense
  combine adds each token's k gated expert outputs one after another, in
  f32, instead of a contraction over all experts.

The expert GEMMs go through :func:`repro_torch.policy.policy_expert_matmul`
(one kernel launch a site for all the local experts; in the dense path the
tokens reach it as a broadcast view, never copied E times).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import current_sharder, shard_tensor
from repro_torch.policy import policy_expert_matmul
from repro_torch.roofline.flops import run_steps

from .common import ArchConfig
from .layers import activate, whole_param
from .module import Ctx

ROUTER_ROWS = 128  # the rows of the router's one GEMM shape
# logical axes of the expert weights (w_in / w_gate, and w_out)
EXPERT_IN_AXES = ("expert", "embed", "expert_mlp")
EXPERT_OUT_AXES = ("expert", "expert_mlp", "embed")


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
    t, d = x.shape
    pad = (-t) % ROUTER_ROWS
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    n = x.shape[0] // ROUTER_ROWS
    # the blocks as the steps of a loop (one step, counted n times, in a
    # meta trace: roofline.flops.run_steps)
    _, out = run_steps(lambda st, xb: (st, xb @ w), (),
                       (x.reshape(1, n, ROUTER_ROWS, d),), n)
    return out.reshape(n * ROUTER_ROWS, -1)[:t]


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


def _capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``tokens`` local tokens (at least top-k)."""
    c = int(np.ceil(tokens * cfg.topk / cfg.n_experts * cfg.capacity_factor))
    return max(c, cfg.topk)


def _local_dispatch_compute(x2d, ids, probs, w_in, w_gate, w_out, e0: int,
                            cfg: ArchConfig):
    """Dispatch local tokens to the E_local experts [e0, e0+E_local), run
    them at (E_local, capacity, d, f), and return the (partial) combined
    output (T, d): the rows of tokens no local expert took are 0."""
    t, d = x2d.shape
    e_local = w_in.shape[0]
    cap = _capacity(t, cfg)
    dev = x2d.device
    flat_ids = ids.reshape(-1)                          # (T*k,)
    tok = torch.arange(flat_ids.numel(), device=dev) // cfg.topk
    le = flat_ids - e0
    mine = (le >= 0) & (le < e_local)
    le_safe = torch.where(mine, le, 0)
    # position of each slot within its expert's capacity buffer
    oh = F.one_hot(torch.where(mine, le, e_local), e_local + 1)
    pos = torch.cumsum(oh, dim=0) - 1
    pos = torch.gather(pos, 1, le_safe[:, None])[:, 0]
    keep = mine & (pos < cap)
    pos_safe = torch.where(keep, pos, cap)              # slot cap: trash row

    buf = torch.zeros((e_local, cap + 1, d), dtype=x2d.dtype, device=dev)
    buf.index_put_((le_safe, pos_safe),
                   torch.where(keep[:, None], x2d[tok], 0), accumulate=True)
    buf = buf[:, :cap]                                  # (E_local, cap, d)

    h = _expert_mm(buf, w_in, cfg, "w_in")
    g = _expert_mm(buf, w_gate, cfg, "w_gate") if w_gate is not None else None
    h = activate(h, g, cfg.act)
    y = _expert_mm(h, w_out, cfg, "w_out")             # (E_local, cap, d)

    y = F.pad(y, (0, 0, 0, 1))                          # the trash row back
    out_slots = torch.where(keep[:, None], y[le_safe, pos_safe], 0)
    return (out_slots.reshape(t, cfg.topk, d)
            * probs.to(out_slots.dtype)[..., None]).sum(dim=1)


def moe_ffn(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: (B, S, d). Returns (out, aux_loss). Parameters
    ``router`` (d, E) f32, ``w_in``/``w_gate`` (E, d, expert_ff) and
    ``w_out`` (E, expert_ff, d); ``w_gate`` only for gated activations.
    Under a sharder they are this rank's shards (``convert.shard_params``);
    ``x`` is whole on every rank (serve rules) or this data rank's rows
    (train rules: the sharder's ``act_batch``)."""
    gated = cfg.act in ("swiglu", "geglu")
    d, ff, e = x.shape[-1], cfg.expert_ff, cfg.n_experts
    router_w, w_in, w_out = (ctx.param("router"), ctx.param("w_in"),
                             ctx.param("w_out"))
    w_gate = ctx.param("w_gate") if gated else None
    sharder = current_sharder()
    if sharder is None:
        return _dense_moe(x, router_w, w_in, w_gate, w_out, cfg)

    n_model = sharder.size("model")
    dp_axes = tuple(a for a in ("pod", "data") if a in sharder.axis_names)
    dp_size = math.prod(sharder.size(a) for a in dp_axes)
    rows_split = bool(dp_axes) and set(dp_axes) <= set(sharder.batch_axes())
    batch = x.shape[0] * (dp_size if rows_split else 1)  # the global batch
    use_ep = (cfg.moe_impl == "ep" and "model" in sharder.axis_names
              and e % n_model == 0 and batch % dp_size == 0
              and d % dp_size == 0 and ff % dp_size == 0)
    if not use_ep and rows_split and dp_size > 1:
        # the load-balance aux of the whole batch is not the mean of the
        # data shards' (the reference's GSPMD computes it on all rows)
        raise NotImplementedError(
            f"{cfg.name}: the dense MoE (moe_impl={cfg.moe_impl!r}) under "
            f"a {dp_size}-way data axis; EP needs the experts ({e}) to "
            f"divide over model ({n_model}) and batch ({batch}), d ({d}) "
            f"and expert_ff ({ff}) to divide over data")
    router_w = whole_param(router_w, ("embed", None), (d, e))
    if not use_ep:
        w_in, w_out = (whole_param(w_in, EXPERT_IN_AXES, (e, d, ff)),
                       whole_param(w_out, EXPERT_OUT_AXES, (e, ff, d)))
        if gated:
            w_gate = whole_param(w_gate, EXPERT_IN_AXES, (e, d, ff))
        return _dense_moe(x, router_w, w_in, w_gate, w_out, cfg)

    # FSDP: gather the contraction dim of the expert weights just in time
    dp = dp_axes or None
    w_in = sharder.all_gather(w_in, dp, 1, downstream="per_rank")
    w_gate = (sharder.all_gather(w_gate, dp, 1, downstream="per_rank")
              if gated else None)
    w_out = sharder.all_gather(w_out, dp, 2, downstream="per_rank")
    coords = sharder.coords()
    x_loc = x if rows_split else shard_tensor(sharder, x, (dp,), coords)
    # every model rank routes the same tokens but runs only its experts:
    # the tokens' and the router's gradients are partial sums (Megatron f)
    x2d = sharder.sum_grad(x_loc.reshape(-1, d), "model")
    ids, probs, aux = _route(x2d, sharder.sum_grad(router_w, "model"), cfg)
    e0 = coords.get("model", 0) * (e // n_model)
    out = _local_dispatch_compute(x2d, ids, probs, w_in, w_gate, w_out, e0,
                                  cfg)
    out = sharder.all_reduce(out, "model", downstream="same")
    aux = sharder.all_reduce(aux.clone(), "model", downstream="same")
    aux = sharder.all_reduce(aux, dp_axes, downstream="per_rank") / (
        n_model * dp_size)
    out = out.reshape(x_loc.shape)
    if rows_split:
        return out, aux
    return sharder.all_gather(out, dp, 0, downstream="same"), aux
