"""Common neural layers with pluggable (exact | DAISM) matmul backend.

Every parameter GEMM routes through :func:`dense`, which resolves its
numerics per op-site through the architecture's approximation policy
(``cfg.approx_policy``, see :mod:`repro_torch.policy`). The dynamic
attention GEMMs (qk^T, att@v) run exact in :func:`attend`; a ``:flash``
rule on an eligible call selects the fused flash-attention kernel
(``kernels/flash_attention.py``), exact or with the rule's DAISM product.

Ported from ``repro/models/layers.py`` with the same masks, sentinels and
chunked online softmax, so f32 rounding stays close to the reference.
Deferred: the tensor-parallel ``shard_map`` branch of paged attention and
the slot caches of ``decode_step``/``prefill``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.config import torch_dtype
from repro_torch.policy import OpKind, attention_kernel, policy_dot, resolve_site

from .common import ArchConfig
from .module import Ctx

_NEG = -1e30        # masked-score sentinel (in the score dtype)
_PAD_POS = 2**30    # kv position of padded keys

# ---------------------------------------------------------------------------
# Dense / norms
# ---------------------------------------------------------------------------


def dense(ctx: Ctx, name: str, x: torch.Tensor, cfg: ArchConfig, *,
          use_bias: bool = False, kind: OpKind = OpKind.DENSE) -> torch.Tensor:
    w = ctx.param(name)
    out = policy_dot(cfg.approx_policy, x, w, name=name, kind=kind)
    if use_bias:
        out = out + ctx.param(name + "_b").to(out.dtype)
    return out


def norm(ctx: Ctx, name: str, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    scale = ctx.param(name + "_scale")
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        bias = ctx.param(name + "_bias")
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
    h = dense(ctx, "wi", x, cfg, use_bias=use_bias)
    g = dense(ctx, "wg", x, cfg) if gated else None
    h = activate(h, g, cfg.act)
    return dense(ctx, "wo", h, cfg, use_bias=use_bias)


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
        site_cfg = resolve_site(policy, "kernel", OpKind.ATTN_QK, q.dtype,
                                record=record, macs=2 * b * h * sq * skv * d,
                                attn_eligible=flash_ok)
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


def self_attention(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, cache: Optional[dict] = None,
                   causal: bool = True, use_bias: bool = False
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA self-attention, non-cached (``forward``) or over the paged KV
    pool (``paged_step``: ``cache`` holds the layer's pool and the resolved
    ``write_idx`` / ``phys_read`` indices)."""
    nh, kh, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    b, s, _ = x.shape
    q = dense(ctx, "wq", x, cfg, use_bias=use_bias).reshape(b, s, nh, hd)
    k = dense(ctx, "wk", x, cfg, use_bias=use_bias).reshape(b, s, kh, hd)
    v = dense(ctx, "wv", x, cfg, use_bias=use_bias).reshape(b, s, kh, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        if "write_idx" not in cache:
            raise NotImplementedError(
                "slot KV caches (decode_step/prefill) are not ported yet; "
                "serve through paged_step")
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
    out = out.reshape(b, s, nh * hd)
    return dense(ctx, "wo", out, cfg, use_bias=use_bias), new_cache


def cross_attention(ctx: Ctx, x: torch.Tensor, kv_src: torch.Tensor,
                    cfg: ArchConfig, *, use_bias: bool = False) -> torch.Tensor:
    """Full (non-causal) cross attention against encoder/image states."""
    nh, kh, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    b, s, _ = x.shape
    skv = kv_src.shape[1]
    q = dense(ctx, "wq", x, cfg, use_bias=use_bias).reshape(b, s, nh, hd)
    k = dense(ctx, "wk", kv_src, cfg, use_bias=use_bias).reshape(b, skv, kh, hd)
    v = dense(ctx, "wv", kv_src, cfg, use_bias=use_bias).reshape(b, skv, kh, hd)
    out = attend(q, k, v, torch.arange(s, device=x.device),
                 torch.arange(skv, device=x.device), causal=False,
                 chunk=skv,  # single chunk: small KV, uniform attn trips
                 score_dtype=cfg.attn_score_dtype, policy=cfg.approx_policy)
    out = out.reshape(b, s, nh * hd)
    return dense(ctx, "wo", out, cfg, use_bias=use_bias)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(ctx: Ctx, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return ctx.param("embedding")[tokens]


def unembed(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        e = ctx.param("embedding")
        return policy_dot(cfg.approx_policy, x, e.t().contiguous(),
                          name="lm_head", kind=OpKind.LM_HEAD)
    return dense(ctx, "lm_head", x, cfg, kind=OpKind.LM_HEAD)
