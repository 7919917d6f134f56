"""Zamba2-style hybrid: a Mamba-2 (SSD) backbone and one *shared* attention
block applied after every ``shared_attn_every`` Mamba blocks
(arXiv:2411.15242).

Ported from ``repro/models/zamba.py``: head-structured SSD with a scalar
decay per head and state N = ``ssm_state``; decode carries each block's
(conv state, SSM state), O(1) a token. The shared block reuses one
parameter set at every site but keeps its own KV cache per site
(``attn_{site}``), a ring buffer of ``window`` cells when the window is
shorter than the cache. The projections route through ``dense`` (the DAISM
GEMM where the policy says so); the depthwise conv and the SSD scan (a
Python loop over time, in f32: ``roofline.flops.run_steps``) are plain
torch ops. Under a sharder the shared block's heads follow
``layers.self_attention`` and a Mamba block gathers what it needs whole
(:func:`mamba_block`). The windowed shared
attention never takes the flash kernel (``layers.attend``: a window is not
flash-eligible).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.config import torch_dtype
from repro_torch.parallel.sharding import current_sharder
from repro_torch.policy import OpKind, plan_segments, site_scope
from repro_torch.roofline.flops import run_steps
from repro_torch.runtime.device import resolve_device

from .common import ArchConfig
from .layers import (dense, embed, local_part, mlp, norm, self_attention,
                     unembed, whole_cols, whole_param)
from .module import (Ctx, ParamSpec, axes_tree, init_params, normal_init,
                     ones_init, zeros_init)
from .transformer import (attn_mats, block_specs, clip_segments, ffn_mats,
                          lm_specs, run_policy_segments)

Params = Dict[str, object]
_IN_PROJ = ("embed", "mlp")


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def _ssd_step(S, x, dt, B_, C, *, decay_rate):
    """S (B, H, P, N); x (B, H, P), dt (B, H), B_ and C (B, N) of one time
    step; ``decay_rate`` = exp(a_log) (H,)."""
    a = torch.exp(-decay_rate[None, :] * dt)                  # (B, H) decay
    S = S * a[..., None, None] + (dt[..., None] * x)[..., None] * \
        B_[:, None, None, :]
    return S, torch.einsum("bhpn,bn->bhp", S, C)


def causal_depthwise_conv(xpad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's ``lax.conv_general_dilated`` over (B, S + K - 1, C)
    with ``HIO`` weights (K, 1, C) and one group per channel, VALID: out[t]
    = sum_j xpad[t + j] w[j] (a cross-correlation, the kernel not flipped).
    Summed tap by tap in f32 and rounded once to the input's dtype, so no
    convolution library (nor its TF32) is involved."""
    k = w.shape[0]
    s = xpad.shape[1] - k + 1
    wf = w[:, 0, :].to(torch.float32)
    out = xpad[:, 0:s].to(torch.float32) * wf[0]
    for j in range(1, k):
        out = out + xpad[:, j:j + s].to(torch.float32) * wf[j]
    return out.to(xpad.dtype)


def _state_layout(cfg: ArchConfig):
    """{leaf: (logical axes, shape, the dim split over model)} of a
    block's decode state, its batch rows left out (``launch/steps.py``'s
    cache table: ``conv`` over ``act_mlp``, ``ssm`` over ``act_heads``)."""
    p = cfg.d_inner // cfg.ssm_heads
    return {"conv": ((None, None, "act_mlp"),
                     (1, cfg.conv_kernel - 1, cfg.d_inner), 2),
            "ssm": ((None, "act_heads", None, None),
                    (1, cfg.ssm_heads, p, cfg.ssm_state), 1)}


def mamba_block(ctx: Ctx, cfg: ArchConfig, x, *, state: Optional[dict] = None):
    """x (B, S, d). ``state`` (decode): {'conv': (B, K-1, d_in), 'ssm': (B,
    H, P, N)}, f32. Returns (x, the new state or None).

    Under a sharder ``in_proj``'s output is gathered whole over ``model``
    (a 16-way column cut gives ranks 0-7 only ``xs`` and 8-15 only ``z``),
    the conv and the SSD run on every channel and head on every rank with
    ``conv_w``, ``a_log`` and ``d_skip`` gathered whole; ``bc_proj``,
    ``dt_proj`` and ``out_proj`` take this rank's part of their K
    (row-parallel sums). ``state`` and the new state are then this rank's
    parts, as the cache holds them."""
    b, s, d = x.shape
    d_in = cfg.d_inner
    nheads = cfg.ssm_heads
    p = d_in // nheads
    kconv = cfg.conv_kernel
    sharded = current_sharder() is not None and state is not None
    if sharded:  # the cache holds this rank's channels and heads
        state = {k: whole_param(state[k], axes, shape)
                 for k, (axes, shape, _) in _state_layout(cfg).items()}

    with ctx.scope("mamba"):
        y_in = norm(ctx, "ln", x, cfg)
        xz = whole_cols(dense(ctx, "in_proj", y_in, cfg, axes=_IN_PROJ,
                              shape=(d, 2 * d_in)), _IN_PROJ, (d, 2 * d_in))
        xs, z = torch.chunk(xz, 2, dim=-1)

        new_conv_state = None
        if state is None:
            xpad = F.pad(xs, (0, 0, kconv - 1, 0))
        else:
            xpad = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
            new_conv_state = xpad[:, -(kconv - 1):, :]
        conv_w = whole_param(ctx.param("conv_w"), ("conv", None, "mlp"),
                             (kconv, 1, d_in))
        xc = F.silu(causal_depthwise_conv(xpad, conv_w))

        # SSD projections
        bc = dense(ctx, "bc_proj", xc, cfg, axes=("mlp", "ssm"),
                   shape=(d_in, 2 * cfg.ssm_state))
        B_, C_ = torch.chunk(bc.to(torch.float32), 2, dim=-1)   # (B, S, N)
        dt = dense(ctx, "dt_proj", xc, cfg, axes=("mlp", "heads"),
                   shape=(d_in, nheads))
        dt = F.softplus(dt.to(torch.float32) + 1.0)             # (B, S, H)
        decay_rate = torch.exp(whole_param(ctx.param("a_log"), ("heads",),
                                           (nheads,)))
        d_skip = whole_param(ctx.param("d_skip"), ("heads",), (nheads,))

        xh = xc.reshape(b, s, nheads, p).to(torch.float32)
        S = (torch.zeros((b, nheads, p, cfg.ssm_state), dtype=torch.float32,
                         device=x.device) if state is None else state["ssm"])
        S, y = run_steps(functools.partial(_ssd_step, decay_rate=decay_rate),
                         S, (xh, dt, B_, C_), s)               # (B,S,H,P)
        y = y + xh * d_skip[None, None, :, None]
        y = y.reshape(b, s, d_in).to(x.dtype)
        y = y * F.silu(z)
        out = dense(ctx, "out_proj", y, cfg, axes=("mlp", "embed"),
                    shape=(d_in, d))

    new_state = None
    if state is not None:
        new_state = {"conv": new_conv_state.to(torch.float32), "ssm": S}
        if sharded:
            new_state = {k: local_part(new_state[k], axes, shape, dim)
                         for k, (axes, shape, dim)
                         in _state_layout(cfg).items()}
    return x + out, new_state


def mamba_block_sites(i: int):
    base = f"zamba/layer_{i}/mamba"
    return [(f"{base}/{n}", OpKind.DENSE)
            for n in ("in_proj", "bc_proj", "dt_proj", "out_proj")]


def shared_attn_block(ctx: Ctx, cfg: ArchConfig, x, *, positions,
                      cache=None):
    """The Zamba shared transformer block (its params reused at every
    site). Returns (x, the attention's new cache or None)."""
    with ctx.scope("attn"):
        h, new_cache = self_attention(ctx, norm(ctx, "ln1", x, cfg), cfg,
                                      positions=positions, cache=cache)
    x = x + h
    with ctx.scope("ffn"):
        x = x + mlp(ctx, norm(ctx, "ln2", x, cfg), cfg)
    return x, new_cache


class ZambaModel:
    """Mamba-2 blocks with the shared attention block after every
    ``shared_attn_every`` of them (6 sites for Zamba2-1.2B's 38 blocks, then
    2 tail blocks): ``forward``, ``init_cache`` and ``decode_step``.
    ``device`` is where :meth:`init` and :meth:`init_cache` allocate; it
    defaults to the card."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family != "hybrid":
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} "
                                      "is not a Zamba hybrid")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.every = cfg.shared_attn_every
        self.n_sites = cfg.n_layers // self.every if self.every else 0
        self.segments = plan_segments(
            cfg.approx_policy, mamba_block_sites, 0, cfg.n_layers)

    def param_specs(self) -> Dict[str, tuple]:
        """``{path: (shape, dtype, init)}`` with the JAX package's paths.
        ``conv_w`` keeps the reference's ``HIO`` layout (K, 1, d_in)."""
        cfg = self.cfg
        L, pd = cfg.n_layers, cfg.param_dtype
        d, d_in, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        specs = lm_specs(cfg)
        block_specs(specs, cfg, "mamba_blocks", L, "mamba", "ln",
                    [("in_proj", (d, 2 * d_in), pd, False, _IN_PROJ),
                     ("bc_proj", (d_in, 2 * cfg.ssm_state), pd, False,
                      ("mlp", "ssm")),
                     ("dt_proj", (d_in, h), pd, False, ("mlp", "heads")),
                     ("out_proj", (d_in, d), pd, False, ("mlp", "embed"))])
        pre = "mamba_blocks/mamba"
        specs[f"{pre}/conv_w"] = ParamSpec(
            (L, cfg.conv_kernel, 1, d_in), pd, normal_init(),
            ("layers", "conv", None, "mlp"))
        specs[f"{pre}/a_log"] = ParamSpec((L, h), "float32", zeros_init(),
                                          ("layers", "heads"))
        specs[f"{pre}/d_skip"] = ParamSpec((L, h), "float32", ones_init(),
                                           ("layers", "heads"))
        if self.n_sites:
            block_specs(specs, cfg, "shared_attn", None, "attn", "ln1",
                        attn_mats(cfg, False))
            block_specs(specs, cfg, "shared_attn", None, "ffn", "ln2",
                        ffn_mats(cfg, False))
        return specs

    def init(self, seed: int = 0) -> Params:
        """Random parameters on ``self.device`` from a ``torch.Generator``
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_specs(), gen, self.device)

    def param_axes(self):
        """Each parameter's logical axes, as a tree like the params'."""
        return axes_tree(self.param_specs())

    def _groups(self):
        """(lo, hi, site): Mamba blocks [lo, hi), then shared site ``site``
        (None: the tail blocks past the last site, or no sites at all)."""
        L, every = self.cfg.n_layers, self.every
        groups = [(s * every, (s + 1) * every, s)
                  for s in range(self.n_sites)]
        tail0 = self.n_sites * every
        if tail0 < L:
            groups.append((tail0, L, None))
        return groups

    def _stack(self, params: Params, x, positions, cache=None):
        """The Mamba blocks and the shared sites, under the ``zamba`` scope
        of the caller. With ``cache`` (decode) every state is written in
        place."""
        cfg = self.cfg

        def mamba_fn(c, xx, st=None):
            xx, new = mamba_block(c, cfg, xx, state=st)
            if st is not None:
                st["conv"].copy_(new["conv"])
                st["ssm"].copy_(new["ssm"])
            return xx, None, 0.0

        states = None if cache is None else {"conv": cache["conv"],
                                             "ssm": cache["ssm"]}
        for lo, hi, site in self._groups():
            x, _ = run_policy_segments(
                mamba_fn, params["mamba_blocks"], x,
                segments=clip_segments(self.segments, lo, hi), cache=states,
                remat=cfg.remat if cache is None else "none")
            if site is None:
                continue
            ac = (None if cache is None
                  else dict(cache[f"attn_{site}"], pos=cache["pos"]))
            with site_scope(f"shared_{site}"):
                x, _ = shared_attn_block(Ctx(params["shared_attn"]), cfg, x,
                                         positions=positions, cache=ac)
        return x

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]):
        """tokens (B, S) -> (logits (B, S, V), aux 0.0)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        ctx = Ctx(params)
        with site_scope("zamba"):
            x = embed(ctx, tokens, cfg)
            x = self._stack(params, x, positions)
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)

    def init_cache(self, batch_size: int, max_seq: int):
        """On ``self.device``: each block's ``conv`` (layers, B, K-1, d_in)
        and ``ssm`` (layers, B, H, P, N) states in f32, ``pos`` an int32
        scalar, and per shared site ``attn_{site}``: ``k``/``v`` (B, size,
        KH, HD) in the compute dtype, with ``abs_pos`` (size,) at -1 when
        ``window`` < ``max_seq`` makes it a ring of ``window`` cells."""
        cfg = self.cfg
        dev = self.device
        p = cfg.d_inner // cfg.ssm_heads
        ring = bool(cfg.window) and cfg.window < max_seq
        size = min(cfg.window, max_seq) if ring else max_seq
        f32 = torch.float32
        cache = {
            "conv": torch.zeros((cfg.n_layers, batch_size,
                                 cfg.conv_kernel - 1, cfg.d_inner),
                                dtype=f32, device=dev),
            "ssm": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_heads, p,
                                cfg.ssm_state), dtype=f32, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
        }
        dt = torch_dtype(cfg.compute_dtype)
        kshape = (batch_size, size, cfg.kv_heads, cfg.head_dim)
        for site in range(self.n_sites):
            c = {"k": torch.zeros(kshape, dtype=dt, device=dev),
                 "v": torch.zeros(kshape, dtype=dt, device=dev)}
            if ring:
                c["abs_pos"] = torch.full((size,), -1, dtype=torch.int32,
                                          device=dev)
            cache[f"attn_{site}"] = c
        return cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache):
        """tokens (B, 1) at the scalar ``cache['pos']``. Returns (logits (B,
        1, V), the cache with ``pos`` advanced by one; its states and KV
        caches are written in place)."""
        cfg = self.cfg
        pos = cache["pos"]
        ctx = Ctx(params)
        with site_scope("zamba"):
            x = embed(ctx, tokens, cfg)
            x = self._stack(params, x, pos.reshape(1), cache=cache)
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        return logits, dict(cache, pos=pos + 1)
