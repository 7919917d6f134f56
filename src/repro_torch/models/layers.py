"""Common neural layers with pluggable (exact | DAISM) matmul backend.

Every parameter GEMM routes through :func:`dense`, which resolves its
numerics per op-site through the architecture's approximation policy
(``cfg.approx_policy``, see :mod:`repro_torch.policy`). The dynamic
attention GEMMs (qk^T, att@v) run exact in :func:`attend`; a ``:flash``
rule on an eligible call selects the fused flash-attention kernel
(``kernels/flash_attention.py``), exact or with the rule's DAISM product.

Ported from ``repro/models/layers.py`` with the same masks, sentinels and
chunked online softmax, so f32 rounding stays close to the reference.

Under a sharder (``repro_torch.parallel.sharding.use_sharder``) the
parameters are this rank's shards and the layers are tensor-parallel, with
explicit collectives where the reference's GSPMD inserts them:

* :func:`dense` computes on the local shard: an output dim sharded over a
  mesh axis stays local (column-parallel: ``wq``/``wk``/``wv``, ``wi``/
  ``wg``); a contraction dim sharded over an axis is all-reduced over it
  (row-parallel: ``attn/wo``, ``ffn/wo``), the bias added after the sum;
* :func:`embed` is vocab-parallel (a masked lookup, then an all-reduce)
  and :func:`unembed` too (local logits, all-gathered, so every rank takes
  the same argmax);
* the paged branch of :func:`self_attention` is head-local: the rank's q
  heads read its slice of the kv-head pool (GQA grouping is contiguous:
  q heads ``[j*nh/n, ...)`` read kv heads ``[j*kh/n, ...)``), so the
  block-table gather/scatter never crosses ranks.
* attention is head-local where the ``model`` axis splits q and kv heads
  alike into whole heads (:func:`heads_local`). Where it cuts inside a
  head (4 kv heads of 64 on a 16-way axis: a rank holds a quarter of one),
  q, k and v are all-gathered to every head (:func:`whole_cols`), the
  attention runs on all of them on every rank, as GSPMD's resharding
  does, and ``wo`` takes this rank's part of its K (``sharded_dot``).
  The recurrent models lay out the same way (``xlstm.py``, ``zamba.py``).

Under the train rules the batch rows are split over the data axes
(``act_batch``), and so is every weight's ``embed`` dim (FSDP, ZeRO-3).
Such a dim is gathered whole before its GEMM or lookup (its gradient is
summed over the data ranks on the way back), and only ``model`` entries
keep the column- and row-parallel meaning above. Under the serve rules
(``act_batch`` whole) a ``data`` entry is a row-parallel K, as before.

Every reshape by heads, ``d_ff`` or vocab reads the local count. Activations
between the layers are whole over ``model`` on every rank.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.config import torch_dtype
from repro_torch.parallel.sharding import (current_sharder, shard_index,
                                           shard_tensor, spec_axes)
from repro_torch.policy import OpKind, attention_kernel, policy_dot, resolve_site
from repro_torch.runtime import trace

from .common import ArchConfig
from .module import Ctx

_NEG = -1e30        # masked-score sentinel (in the score dtype)
_PAD_POS = 2**30    # kv position of padded keys

# the logical axes of the attention and MLP matrices
ATTN_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
             "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
FFN_AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")}

# ---------------------------------------------------------------------------
# Dense / norms
# ---------------------------------------------------------------------------


def fsdp_whole(w: torch.Tensor, axes, shape) -> torch.Tensor:
    """A parameter with its FSDP dims (split over the batch axes) gathered
    whole, under a sharder; ``w`` itself otherwise."""
    sharder = current_sharder()
    if sharder is None:
        return w
    for dim, entry in enumerate(sharder.spec(axes, shape)):
        if sharder.is_fsdp(entry):
            w = sharder.all_gather(w, entry, dim, downstream="per_rank")
    return w


def whole_param(w: torch.Tensor, axes, shape) -> torch.Tensor:
    """A parameter gathered whole along every dim the sharder splits, under
    a sharder (``w`` itself otherwise): an FSDP dim sums its gradient over
    the data ranks, a ``model`` dim serves the same work on every model
    rank (its gradient: this rank's part)."""
    sharder = current_sharder()
    if sharder is None:
        return w
    for dim, entry in enumerate(sharder.spec(axes, shape)):
        w = sharder.all_gather(w, entry, dim, downstream="per_rank"
                               if sharder.is_fsdp(entry) else "same")
    return w


def out_entry(sharder, axes, shape):
    """The spec entry a (K, N) weight's N is split over (None: whole, or
    split only by FSDP, which ``sharded_dot`` gathers)."""
    entry = (sharder.spec(axes, shape) + (None, None))[1]
    return None if sharder.is_fsdp(entry) else entry


def whole_cols(x: torch.Tensor, axes, shape) -> torch.Tensor:
    """A ``dense`` output (local along a split N) gathered to the whole N
    on every rank, under a sharder; ``x`` otherwise. What follows must be
    the same work on every rank (the gradient keeps this rank's part)."""
    sharder = current_sharder()
    if sharder is None:
        return x
    return sharder.all_gather(x, out_entry(sharder, axes, shape), -1,
                              downstream="same")


def local_part(x: torch.Tensor, axes, shape, dim: int) -> torch.Tensor:
    """This rank's part of a whole ``x`` along ``dim``, cut as a tensor of
    logical ``axes`` and global ``shape`` is cut there, under a sharder;
    ``x`` otherwise. Each rank uses its own part, so the gradient of the
    whole is summed over the axis."""
    sharder = current_sharder()
    if sharder is None:
        return x
    entry = (sharder.spec(axes, shape) + (None,) * len(shape))[dim]
    spec = [None] * x.dim()
    spec[dim] = entry
    return shard_tensor(sharder, sharder.sum_grad(x, entry), tuple(spec),
                        sharder.coords())


def heads_local(cfg: ArchConfig) -> bool:
    """Whether the ``model`` split of ``wq`` and of ``wk``/``wv`` gives
    every rank whole heads, the same share of q and kv heads (always,
    without a sharder)."""
    sharder = current_sharder()
    if sharder is None:
        return True
    d = cfg.d_model
    nq = sharder.ways(out_entry(sharder, ATTN_AXES["wq"], (d, cfg.q_dim)))
    nk = sharder.ways(out_entry(sharder, ATTN_AXES["wk"], (d, cfg.kv_dim)))
    return nq == nk and cfg.n_heads % nq == 0 and cfg.kv_heads % nk == 0


def sharded_dot(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor, *,
                name: str, kind: OpKind, axes, shape):
    """``x @ w`` where ``w`` is this rank's shard of a (K, N) = ``shape``
    weight with logical ``axes``; ``x`` is whole or already split along K.
    Returns (the output: summed over K's mesh axes, local along a sharded
    N; the spec entry of N, None when N is whole). FSDP dims (the batch
    axes) are gathered first; the whole ``x`` that each rank uses only in
    part (column-parallel, or sliced along K) takes Megatron's ``f``."""
    sharder = current_sharder()
    if sharder is None or axes is None:
        return policy_dot(cfg.approx_policy, x, w, name=name, kind=kind), None
    w = fsdp_whole(w, axes, shape)  # ZeRO-3: every data rank, its own rows
    k_entry, n_entry = (None if sharder.is_fsdp(e) else e for e in
                        (sharder.spec(axes, shape) + (None, None))[:2])
    if n_entry is not None:        # column-parallel
        x = sharder.sum_grad(x, n_entry)
    if x.shape[-1] != w.shape[0]:  # whole x: take this rank's K slice
        x = shard_tensor(sharder, sharder.sum_grad(x, k_entry),
                         (None,) * (x.dim() - 1) + (k_entry,),
                         sharder.coords())
    out = policy_dot(cfg.approx_policy, x, w, name=name, kind=kind,
                     global_kn=tuple(shape))
    if k_entry is not None:  # row-parallel: the partial sums, summed
        out = sharder.all_reduce(out, k_entry, downstream="same")
    if n_entry is not None and "model" not in spec_axes(n_entry):
        # an N over the data axes (the serve rules' ``embed``): the
        # activations between the layers are whole
        out = sharder.all_gather(out, n_entry, -1, downstream="same")
        n_entry = None
    return out, n_entry


def dense(ctx: Ctx, name: str, x: torch.Tensor, cfg: ArchConfig, *,
          use_bias: bool = False, kind: OpKind = OpKind.DENSE,
          axes=None, shape=None) -> torch.Tensor:
    """``x @ w`` (+ bias) at the policy's site ``name``. ``axes`` and
    ``shape`` (K, N) are the weight's logical axes and global shape, read
    only under a sharder (see the module doc)."""
    w = ctx.param(name)
    out, n_entry = sharded_dot(cfg, x, w, name=name, kind=kind, axes=axes,
                               shape=shape)
    if use_bias:
        b = ctx.param(name + "_b")
        sharder = current_sharder()
        if sharder is not None and axes is not None:
            # laid out as ``out``: local along N's split, else whole
            entry = (sharder.spec(axes[-1:], shape[-1:]) + (None,))[0]
            if entry != n_entry:
                b = whole_param(b, axes[-1:], shape[-1:])
        out = out + b.to(out.dtype)
    return out


def norm(ctx: Ctx, name: str, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """RMS or layer norm over the last dim; the scale and bias are whole on
    every rank (``act_embed``: split over the data axes by the serve
    rules, gathered here)."""
    d = (cfg.d_model,)
    scale = whole_param(ctx.param(name + "_scale"), ("act_embed",), d)
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        bias = whole_param(ctx.param(name + "_bias"), ("act_embed",), d)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * scale
    return y.to(x.dtype)


def activate(h: torch.Tensor, g: Optional[torch.Tensor], act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; so does this port
    if act == "swiglu":
        return F.silu(g) * h
    if act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    if act == "relu2":
        r = F.relu(h)
        return r * r
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(act)


def mlp(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig, *,
        use_bias: bool = False) -> torch.Tensor:
    gated = cfg.act in ("swiglu", "geglu")
    up, down = (cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)
    h = dense(ctx, "wi", x, cfg, use_bias=use_bias, axes=FFN_AXES["wi"],
              shape=up)
    g = dense(ctx, "wg", x, cfg, axes=FFN_AXES["wg"], shape=up) \
        if gated else None
    h = activate(h, g, cfg.act)
    return dense(ctx, "wo", h, cfg, use_bias=use_bias, axes=FFN_AXES["wo"],
                 shape=down)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_freqs(d: int, theta: float, device: str) -> torch.Tensor:
    # built in numpy float32, as the reference builds them; cached per
    # device so a step on the card copies nothing from the host
    freqs = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, float(theta), str(x.device))
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (online-softmax over KV chunks; causal / window)
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
           causal: bool, window: int = 0, chunk: int = 1024,
           softcap: float = 0.0, score_dtype="float32", policy=None,
           record: bool = True) -> torch.Tensor:
    """Online-softmax attention (never materializes the full S x S matrix).

    q: (B, Sq, H, D); k, v: (B, Skv, KH, D); *_pos: (Sq,) / (Skv,) absolute
    positions used for causal/window masking, or (B, Sq) / (B, Skv) per-row
    positions (the paged serving path, where every row is an independent
    request at its own offset).

    With ``policy`` set, the call resolves the ambient ``kernel`` site
    (OpKind.ATTN_QK); a rule that opts into ``:flash`` on an eligible shape
    (shared 1-D positions, no window, no softcap, and sq == skv when causal:
    the kernel masks by index) runs the flash-attention kernel under the
    resolved config. Ineligible calls resolve, and are recorded, as EXACT
    and take the path below.
    """
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if policy is not None:
        flash_ok = (q_pos.dim() == 1 and kv_pos.dim() == 1 and window == 0
                    and softcap == 0.0 and (not causal or sq == skv))
        # dims of one head's qk^T contraction (the flash kernel's grid unit)
        site_cfg = resolve_site(policy, "kernel", OpKind.ATTN_QK, q.dtype,
                                record=record, macs=2 * b * h * sq * skv * d,
                                dims=(sq, d, skv), attn_eligible=flash_ok)
        if flash_ok and site_cfg.attn_kernel == "flash":
            return attention_kernel(site_cfg)(q, k, v, causal)
    k = _repeat_kv(k, h // kh)
    v = _repeat_kv(v, h // kh)
    scale = 1.0 / np.sqrt(d)
    sd = torch_dtype(score_dtype)
    qf = (q.to(torch.float32) * scale).to(sd)

    per_row = q_pos.dim() == 2 or kv_pos.dim() == 2
    if per_row:
        q_pos = (q_pos if q_pos.dim() == 2 else q_pos[None]).expand(b, sq)
        kv_pos = (kv_pos if kv_pos.dim() == 2 else kv_pos[None]).expand(b, skv)

    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=_PAD_POS)

    m = torch.full((b, h, sq), -float("inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb, vb = k[:, sl], v[:, sl]
        pb = kv_pos[..., sl]                      # (C,) | (B, C)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.to(sd))
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        if per_row:  # (B, Sq, C) masks from (B, C) x (B, Sq) positions
            mask = pb[:, None, :] < _PAD_POS
            if causal:
                mask = mask & (pb[:, None, :] <= q_pos[:, :, None])
            if window > 0:
                mask = mask & (pb[:, None, :] > (q_pos[:, :, None] - window))
            mask = mask[:, None]             # broadcast over heads
        else:
            mask = pb[None, :] < _PAD_POS
            if causal:
                mask = mask & (pb[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (pb[None, :] > (q_pos[:, None] - window))
            mask = mask[None, None]
        s = s.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, s.amax(-1).to(torch.float32))
        corr = torch.exp(m - m_new)
        p = torch.exp(s.to(torch.float32) - m_new[..., None]).to(sd)
        l = l * corr + p.to(torch.float32).sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.float32),
            vb.to(sd).to(torch.float32))
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, D)


def _paged_kv_attend(q, k, v, ck, cv, widx, phys_read, positions, *,
                     causal, window, chunk, softcap):
    """Scatter new K/V into the physical page pool, gather each row's pages,
    attend.

    ``ck``/``cv`` are one layer's pool, updated in place. Their last cell is
    a sink: writes the reference drops (``mode="drop"``, index >= cells)
    land there instead, and no read ever gathers it.
    """
    cells = ck.shape[0] - 1
    ck.index_put_((widx.reshape(-1),), k.reshape(-1, *k.shape[2:]).to(ck.dtype))
    cv.index_put_((widx.reshape(-1),), v.reshape(-1, *v.shape[2:]).to(cv.dtype))
    idx = phys_read.clamp(max=cells - 1)
    gk = ck[idx]  # (B, K, KH, HD)
    gv = cv[idx]
    kv_pos = torch.arange(gk.shape[1], device=q.device)
    return attend(q, gk, gv, positions, kv_pos, causal=causal, window=window,
                  chunk=chunk, softcap=softcap)


def _paged_shard_axis(sharder, q_shape, pool_shape) -> Optional[str]:
    """Mesh axis the head-local paged attention splits heads over, or None.

    Eligible only when the sharder lands the *same single* mesh axis on
    both the activation heads dim of ``q`` (B, S, H, D) and the pool's
    kv-heads dim (cells, KH, D); its divisibility fallback drops axes that
    do not divide, so an indivisible head count gives None (the engine
    then refuses the layout)."""
    if sharder is None:
        return None
    qspec = sharder.spec((None, None, "act_heads", None), q_shape)
    pspec = sharder.spec((None, "act_kv_heads", None), pool_shape)
    axq = qspec[2] if len(qspec) > 2 else None
    axp = pspec[1] if len(pspec) > 1 else None
    return axq if isinstance(axq, str) and axq == axp else None


def _update_slice(buf: torch.Tensor, dim: int, start: torch.Tensor,
                  new: torch.Tensor) -> None:
    """``lax.dynamic_update_slice`` along ``dim``, in place: ``new`` lands
    at ``start`` clamped to ``[0, size - len]`` (a start past the end moves
    back until the slice fits, as XLA clamps it). ``start`` is a device
    scalar, so nothing waits for the card."""
    n = new.shape[dim]
    lo = start.clamp(0, buf.shape[dim] - n)
    buf.index_copy_(dim, lo + torch.arange(n, device=buf.device),
                    new.to(buf.dtype))


def _slot_kv_attend(q, k, v, cache, positions, cfg: ArchConfig, *, causal):
    """Write the new K/V into one layer's slot cache and attend over it.

    ``cache`` holds the layer's ``k``/``v`` (B, size, KH, HD) views of the
    stacked cache (written in place), ``pos`` (a scalar: every row at one
    offset; or (B,): row ``i`` writes at ``pos[i]``) and, for a ring
    buffer, the layer's ``abs_pos`` (size,) view: the absolute position of
    each cell, -1 while empty. Returns (out, the layer's new cache)."""
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    b, s = k.shape[:2]
    size = ck.shape[1]
    ring = "abs_pos" in cache
    if pos.dim() == 1:  # per-slot cache: row i writes at pos[i]
        if ring:
            raise NotImplementedError(
                "per-slot caches do not support ring/window buffers")
        start = pos.long().clamp(0, size - s)[:, None] + torch.arange(
            s, device=ck.device)
        rows = torch.arange(b, device=ck.device)[:, None]
        ck[rows, start] = k.to(ck.dtype)
        cv[rows, start] = v.to(cv.dtype)
    else:
        slot = torch.remainder(pos, size) if ring else pos
        slot = slot.long()
        _update_slice(ck, 1, slot, k)
        _update_slice(cv, 1, slot, v)
    new_cache = dict(k=ck, v=cv, pos=pos + s)
    if ring:
        ap = cache["abs_pos"]
        _update_slice(ap, 0, slot, positions)
        new_cache["abs_pos"] = ap
        kv_pos = torch.where(ap < 0, _PAD_POS, ap)  # empty cells masked out
    else:
        kv_pos = torch.arange(size, device=ck.device)
    out = attend(q, ck, cv, positions, kv_pos, causal=causal,
                 window=cfg.window, chunk=cfg.attn_chunk,
                 softcap=cfg.logit_softcap)
    return out, new_cache


def _qkv(ctx: Ctx, x: torch.Tensor, kv_src: torch.Tensor, cfg: ArchConfig,
         use_bias: bool):
    """q from ``x`` and k, v from ``kv_src``, (B, S, H, HD) each: this
    rank's heads where they are head-local, else every head (module doc)."""
    hd, d = cfg.head_dim, cfg.d_model
    local = heads_local(cfg)
    out = []
    for name, src, n in (("wq", x, cfg.q_dim), ("wk", kv_src, cfg.kv_dim),
                         ("wv", kv_src, cfg.kv_dim)):
        t = dense(ctx, name, src, cfg, use_bias=use_bias,
                  axes=ATTN_AXES[name], shape=(d, n))
        if not local:
            t = whole_cols(t, ATTN_AXES[name], (d, n))
        out.append(t.reshape(*src.shape[:2], -1, hd))
    return out


def self_attention(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, cache: Optional[dict] = None,
                   causal: bool = True, use_bias: bool = False
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self-attention: non-cached (``forward``), over a slot cache
    (``decode_step``/``prefill``: ``cache`` holds the layer's ``k``/``v``,
    ``pos`` and, for a ring, ``abs_pos``) or over the paged KV pool
    (``paged_step``: ``cache`` holds the layer's pool and the resolved
    ``write_idx`` / ``phys_read`` indices). Under a sharder the heads are
    this rank's (module doc)."""
    d = cfg.d_model
    b, s, _ = x.shape
    q, k, v = _qkv(ctx, x, x, cfg, use_bias)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and "write_idx" not in cache:
        # slot KV cache (decode_step / prefill): attention is exact, as in
        # the reference (no policy: no flash, no DAISM product)
        out, new_cache = _slot_kv_attend(q, k, v, cache, positions, cfg,
                                         causal=causal)
    elif cache is not None:
        # paged KV cache: per-layer physical page pool k/v (P + 1, KH, HD);
        # the request's block table is pre-resolved by DecoderLM.paged_step
        # into write_idx (B, S): physical cell of each new token (P = the
        # sink: dropped), and phys_read (B, K): physical cell of every
        # logical kv position (clipped gather; unmapped entries land beyond
        # the row's write position, so the causal mask excludes them).
        out = _paged_kv_attend(
            q, k, v, cache["k"], cache["v"], cache["write_idx"],
            cache["phys_read"], positions, causal=causal, window=cfg.window,
            chunk=cfg.attn_chunk, softcap=cfg.logit_softcap)
        new_cache = dict(k=cache["k"], v=cache["v"])
    else:
        out = attend(q, k, v, positions, positions, causal=causal,
                     window=cfg.window, chunk=cfg.attn_chunk,
                     softcap=cfg.logit_softcap,
                     score_dtype=cfg.attn_score_dtype,
                     policy=cfg.approx_policy)
    out = out.reshape(b, s, -1)
    return dense(ctx, "wo", out, cfg, use_bias=use_bias, axes=ATTN_AXES["wo"],
                 shape=(cfg.q_dim, d)), new_cache


def cross_attention(ctx: Ctx, x: torch.Tensor, kv_src: torch.Tensor,
                    cfg: ArchConfig, *, use_bias: bool = False) -> torch.Tensor:
    """Full (non-causal) cross attention against encoder/image states;
    under a sharder the heads are this rank's, as in
    :func:`self_attention`."""
    d = cfg.d_model
    b, s, _ = x.shape
    skv = kv_src.shape[1]
    q, k, v = _qkv(ctx, x, kv_src, cfg, use_bias)
    out = attend(q, k, v, torch.arange(s, device=x.device),
                 torch.arange(skv, device=x.device), causal=False,
                 chunk=skv,  # single chunk: small KV, uniform attn trips
                 score_dtype=cfg.attn_score_dtype, policy=cfg.approx_policy)
    out = out.reshape(b, s, -1)
    return dense(ctx, "wo", out, cfg, use_bias=use_bias, axes=ATTN_AXES["wo"],
                 shape=(cfg.q_dim, d))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(ctx: Ctx, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Embedding lookup; vocab-parallel under a sharder: each rank looks up
    the tokens in its rows (the others read 0), and the sum over the
    vocab's mesh axes is the whole embedding, bit for bit. An FSDP ``embed``
    dim (train rules) is gathered into the table first; otherwise (serve
    rules) the looked-up columns are gathered."""
    with trace.span("model.embed", annotate=False):
        e = ctx.param("embedding")
        sharder = current_sharder()
        if sharder is None:
            return e[tokens]
        v_entry, d_entry = (sharder.spec(("vocab", "embed"),
                                         (cfg.vocab, cfg.d_model))
                            + (None, None))[:2]
        e = fsdp_whole(e, ("vocab", "embed"), (cfg.vocab, cfg.d_model))
        if sharder.is_fsdp(d_entry):
            d_entry = None
        if v_entry is not None:
            rows = e.shape[0]
            local = tokens - shard_index(sharder, v_entry,
                                         sharder.coords()) * rows
            mine = (local >= 0) & (local < rows)
            x = torch.where(mine[..., None], e[local.clamp(0, rows - 1)], 0)
            x = sharder.all_reduce(x, v_entry, downstream="same")
        else:
            x = e[tokens]
        return sharder.all_gather(x, d_entry, -1, downstream="same")


def tied_lm_head(e: torch.Tensor) -> torch.Tensor:
    """The tied lm_head's (d, V) operand: ``e.T`` made contiguous (the GEMM
    kernel reads its ``w`` row-major), the same bits however it is taken.

    The copy is taken once per embedding tensor and kept on it (for
    Gemma-2B's (256000, 2048) bf16 table a copy takes 6.4 ms on the H100,
    15% of a decode step; PERF.md), and taken again once the tensor has
    been written in place (its version counter moved). While the
    embedding takes gradients, or on the ``meta`` device, it is taken at
    every call. An inference tensor has no version counter and can be
    written only inside ``torch.inference_mode``; its copy is kept as it
    was taken."""
    if e.requires_grad or e.device.type == "meta":
        return e.t().contiguous()
    version = None if torch.is_inference(e) else e._version
    kept = getattr(e, "_repro_lm_head", None)
    if kept is None or kept[0] != version:
        kept = (version, e.t().contiguous())
        e._repro_lm_head = kept
    return kept[1]


def unembed(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The logits; vocab-parallel under a sharder, all-gathered, so every
    rank holds all of them."""
    with trace.span("model.lm_head"):
        w = (tied_lm_head(ctx.param("embedding")) if cfg.tie_embeddings
             else ctx.param("lm_head"))
        logits, v_entry = sharded_dot(cfg, x, w, name="lm_head",
                                      kind=OpKind.LM_HEAD,
                                      axes=("embed", "vocab"),
                                      shape=(cfg.d_model, cfg.vocab))
        if v_entry is None:
            return logits
        return current_sharder().all_gather(logits, v_entry, -1,
                                            downstream="same")
