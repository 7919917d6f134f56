"""Plain-torch forward passes of the benchmark's two architectures.

* :func:`decoder_layer` and :func:`decoder_logits`: a dense pre-norm
  decoder (StarCoder2-15B: token embedding, LayerNorm, grouped-query
  attention with rotary positions, GELU MLP, every projection with a
  bias, an untied lm_head), its attention over the sequence
  (:func:`causal_attention`) or over a page pool (:func:`paged_attention`).
* :func:`encoder_layer` and :func:`encdec_layer`: the Whisper blocks
  (bidirectional encoder blocks; decoder blocks with cross attention to
  the encoder states, their self-attention over a slot cache,
  :func:`slot_attention`).
* :func:`head`: the final LayerNorm and the lm_head.

They read the parameter tree that the benchmark drew (``weights.py``) and
follow the dtypes of a bf16 deployment: activations in bf16 between the
ops, LayerNorm and softmax in f32, every projection through
``sites[name]``: ``"approx"`` (the DAISM GEMM of ``daism.py``, f32 sum,
rounded to bf16, then the bf16 bias), or ``"exact"`` (a bf16 matmul).
``flash=True`` runs the causal self-attention as an online softmax over
128-key tiles whose QK and PV contractions are DAISM products, with the
probabilities rounded to bf16 before PV; otherwise attention is exact in
f32. ``lower=True`` rounds every DAISM GEMM's operands to float8 first
(the control). Departures from the published Whisper, which the program
shares and the reference therefore shares: the decoder has no positional
embedding, the encoder ends without a final LayerNorm, and the key
projections carry a bias.

Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import daism

NEG = -1e30
BF16 = torch.bfloat16


class Numerics:
    """How the reference computes: the DAISM ``variant``, the mode of each
    projection site (``attn``, ``xattn``, ``ffn``, ``lm_head``: ``approx``
    or ``exact``), whether self-attention is the approximate flash
    attention, and whether the control's lower precision is on."""

    def __init__(self, variant: str, sites: Dict[str, str],
                 flash: bool = False, lower: bool = False):
        self.variant = variant
        self.sites = sites
        self.flash = flash
        self.lower = lower

    def dense(self, site: str, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self.sites[site] == "approx":
            out = daism.matmul(x2, w, self.variant,
                               lower=self.lower).to(x.dtype)
        else:
            out = x2 @ w.to(x.dtype)
        out = out.reshape(*lead, w.shape[-1])
        if b is not None:
            out = out + b.to(out.dtype)
        return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions, rotate-half form; x (B, S, H, D)."""
    d = x.shape[-1]
    freqs = torch.from_numpy(
        (1.0 / theta ** (np.arange(0, d, 2, dtype=np.float32) / d)
         ).astype(np.float32)).to(x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def exact_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Softmax attention in f32; q (B, Sq, H, D), k/v (B, Skv, KH, D)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    qf = q.float().transpose(1, 2) * (1.0 / math.sqrt(d))
    s = qf @ k.float().permute(0, 2, 3, 1)
    if causal:
        skv = k.shape[1]
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(
            skv - sq)
        s = s.masked_fill(~mask, NEG)
    p = torch.softmax(s, dim=-1)
    out = p @ v.float().transpose(1, 2)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, num: Numerics, *, block_k: int = 128):
    """Causal attention, online softmax over ``block_k``-key tiles, QK and
    PV through the DAISM product (q and p the multipliers), p rounded to
    bf16 before PV; q (B, S, H, D), k/v (B, S, KH, D)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    qt = q.transpose(1, 2).reshape(b * h, s, d)
    kt = k.transpose(1, 2).reshape(b * h, s, d)
    vt = v.transpose(1, 2).reshape(b * h, s, d)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    dev = q.device
    q_pos = torch.arange(s, device=dev)[:, None]
    m = torch.full((b * h, s), -float("inf"), device=dev)
    l = torch.zeros((b * h, s), device=dev)
    acc = torch.zeros((b * h, s, d), device=dev)
    for j in range(0, s, block_k):
        kb = kt[:, j:j + block_k]
        vb = vt[:, j:j + block_k]
        sc = daism.matmul(qt, kb.transpose(1, 2).contiguous(), num.variant,
                          lower=num.lower) * scale
        k_pos = j + torch.arange(kb.shape[1], device=dev)
        mask = k_pos[None, :] <= q_pos
        sc = torch.where(mask, sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        pv = daism.matmul(p.to(BF16), vb.contiguous(), num.variant,
                          lower=num.lower)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)
    return out.reshape(b, h, s, d).transpose(1, 2)


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def mlp(p: dict, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    h = num.dense("ffn", x, p["wi"], p["wi_b"])
    h = F.gelu(h, approximate="tanh")
    return num.dense("ffn", h, p["wo"], p["wo_b"])


def _proj(p: dict, site: str, x, kv_src, num: Numerics, hd: int):
    q = num.dense(site, x, p["wq"], p["wq_b"])
    k = num.dense(site, kv_src, p["wk"], p["wk_b"])
    v = num.dense(site, kv_src, p["wv"], p["wv_b"])
    return (q.reshape(*x.shape[:2], -1, hd),
            k.reshape(*kv_src.shape[:2], -1, hd),
            v.reshape(*kv_src.shape[:2], -1, hd))


def decoder_layer(blk: dict, x: torch.Tensor, num: Numerics, hd: int,
                  attention) -> torch.Tensor:
    """One pre-norm block: self-attention through ``attention(q, k, v)``
    (which places positions and any cache), then the MLP."""
    a = blk["attn"]
    h = layer_norm(x, a["ln1_scale"], a["ln1_bias"])
    o = attention(*_proj(a, "attn", h, h, num, hd))
    x = x + num.dense("attn", o.reshape(*o.shape[:2], -1), a["wo"], a["wo_b"])
    f = blk["ffn"]
    return x + mlp(f, layer_norm(x, f["ln2_scale"], f["ln2_bias"]), num)


def causal_attention(cfg: dict, positions: torch.Tensor, num: Numerics):
    """Rotary positions, then causal self-attention over the sequence
    itself: the approximate flash attention or exact."""
    def attention(q, k, v):
        if cfg.get("rope_theta"):
            q = rope(q, positions, cfg["rope_theta"])
            k = rope(k, positions, cfg["rope_theta"])
        if num.flash:
            return flash_attention(q, k, v, num)
        return exact_attention(q, k, v, causal=True)
    return attention


def paged_attention(cfg: dict, positions, write_idx, phys_read, pool_k,
                    pool_v):
    """Rotary positions at each row's ``positions`` (B, S), the new K/V
    written into the page pools (copies of one layer's, last cell the drop
    sink) at ``write_idx``, then exact attention over each row's gathered
    pages, masked causally by logical position."""
    def attention(q, k, v):
        q = rope(q, positions, cfg["rope_theta"])
        k = rope(k, positions, cfg["rope_theta"])
        ck, cv = pool_k.clone(), pool_v.clone()
        ck[write_idx.reshape(-1)] = k.reshape(-1, *k.shape[2:]).to(ck.dtype)
        cv[write_idx.reshape(-1)] = v.reshape(-1, *v.shape[2:]).to(cv.dtype)
        idx = phys_read.clamp(max=ck.shape[0] - 2)
        return _masked_attention(q, ck[idx], cv[idx], positions)
    return attention


def slot_attention(pos: int, cache_k, cache_v):
    """The new K/V written at ``pos`` of one layer's slot cache (copies),
    then exact attention over positions ``<= pos``."""
    def attention(q, k, v):
        ck, cv = cache_k.clone(), cache_v.clone()
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        q_pos = torch.full((q.shape[0], 1), pos, device=q.device)
        return _masked_attention(q, ck, cv, q_pos)
    return attention


def _masked_attention(q, k, v, q_pos):
    """Exact attention in f32 where key ``j`` (logical position j) is seen
    by a query at position ``p`` iff ``j <= p``; q_pos (B, Sq)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    s = (q.float().transpose(1, 2) * (1.0 / math.sqrt(d))) @ k.float().permute(
        0, 2, 3, 1)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]
    s = s.masked_fill(~mask[:, None], NEG)
    out = torch.softmax(s, dim=-1) @ v.float().transpose(1, 2)
    return out.transpose(1, 2).to(q.dtype)


def head(params: dict, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    """The final LayerNorm and the lm_head: logits in bf16."""
    x = layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])
    return num.dense("lm_head", x, params["lm_head"])


def decoder_logits(params: dict, cfg: dict, tokens: torch.Tensor,
                   num: Numerics) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) bf16 of the dense decoder."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    attention = causal_attention(cfg, positions, num)
    x = params["embedding"][tokens]
    for i in range(cfg["n_layers"]):
        x = decoder_layer(layer(params["blocks"], i), x, num,
                          cfg["head_dim"], attention)
    return head(params, x, num)


def encoder_layer(blk: dict, x: torch.Tensor, num: Numerics,
                  hd: int) -> torch.Tensor:
    """One bidirectional encoder block."""
    return decoder_layer(
        blk, x, num, hd,
        lambda q, k, v: exact_attention(q, k, v, causal=False))


def encdec_layer(blk: dict, x: torch.Tensor, enc: torch.Tensor,
                 num: Numerics, hd: int, attention) -> torch.Tensor:
    """One Whisper decoder block: self-attention through ``attention``,
    cross attention to ``enc``, the MLP."""
    a = blk["attn"]
    h = layer_norm(x, a["ln1_scale"], a["ln1_bias"])
    o = attention(*_proj(a, "attn", h, h, num, hd))
    x = x + num.dense("attn", o.reshape(*o.shape[:2], -1), a["wo"], a["wo_b"])
    c = blk["xattn"]
    h = layer_norm(x, c["lnx_scale"], c["lnx_bias"])
    o = exact_attention(*_proj(c, "xattn", h, enc, num, hd), causal=False)
    x = x + num.dense("xattn", o.reshape(*o.shape[:2], -1), c["wo"],
                      c["wo_b"])
    f = blk["ffn"]
    return x + mlp(f, layer_norm(x, f["ln2_scale"], f["ln2_bias"]), num)

