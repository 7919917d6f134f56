"""xLSTM (sLSTM + mLSTM blocks), an attention-free LM (arXiv:2405.04517).

Ported from ``repro/models/xlstm.py``: exponential gating with the
max-stabiliser state, matrix memory per head in the mLSTM, block-diagonal
recurrence in the sLSTM. Every projection routes through ``dense`` (the
DAISM GEMM where the policy says so); the recurrences are elementwise and
stay plain torch ops in f32 (``rnn_state_dtype``). The reference's
``lax.scan`` over time is a Python loop over the sequence here
(``roofline.flops.run_steps``).

Under a sharder the input projections are gathered whole over ``model``
and the cells run on every head on every rank; ``wo``/``w_down`` take this
rank's part of their K (row-parallel), and the states are whole over
``model`` (the cache splits them by batch rows only, as the reference's).

Parameters are the reference's tree: the mLSTM and sLSTM blocks are two
separate stacks, so a stack's row is not the global layer number; the
mLSTM groups run through ``run_policy_segments`` with ``base``. The cache
holds each stack's states as tuples (mLSTM ``(C, n, m)``, sLSTM ``(c, n, m,
h)``), written in place by ``decode_step``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch

from repro_torch.core.config import torch_dtype
from repro_torch.policy import OpKind, plan_segments, site_scope
from repro_torch.roofline.flops import run_steps
from repro_torch.runtime.device import resolve_device

from .common import ArchConfig
from .layers import dense, embed, norm, unembed, whole_cols, whole_param
from .module import (Ctx, ParamSpec, axes_tree, init_params, layer_slice,
                     normal_init)
from .transformer import (block_specs, clip_segments, lm_specs,
                          run_policy_segments)

Params = Dict[str, object]
# the logical axes of the cells' projections (in: embed -> heads)
_IN, _OUT = ("embed", "heads"), ("heads", "embed")


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C (hd x hd) per head, exponential gating
# ---------------------------------------------------------------------------

def _mlstm_step(state, q, k, v, i_pre, f_pre):
    """state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)); q, k, v (B,H,hd) and
    the gates (B,H) of one time step. The stabiliser ``m`` starts at -inf,
    where ``exp(f + m - m_new)`` is 0 (``m_new`` is then ``i_pre``)."""
    C, n, m = state
    sd = C.dtype
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None].to(sd)
    f_g = torch.exp(f_pre + m - m_new)[..., None].to(sd)
    ks, qs = k.to(sd), q.to(sd)
    C = f_g[..., None] * C + i_g[..., None] * (
        v.to(sd)[..., :, None] * ks[..., None, :])
    n = f_g * n + i_g * ks
    num = torch.einsum("bhij,bhj->bhi", C.float(), qs.float())
    den = torch.einsum("bhj,bhj->bh", n.float(), qs.float()).abs().clamp(
        min=1.0)
    return (C, n, m_new), num / den[..., None]


def _proj(ctx: Ctx, x, cfg: ArchConfig, name: str, n: int):
    """An input projection (d -> n), whole on every rank: under a sharder
    its columns are gathered over ``model`` (the layers' module doc), so
    the cell runs on every head, as the reference's GSPMD resharding does
    where a 16-way axis cuts inside xLSTM-1.3B's 4 heads or ``wgate``'s
    ``[i | f | o]``."""
    axes, shape = _IN, (cfg.d_model, n)
    return whole_cols(dense(ctx, name, x, cfg, axes=axes, shape=shape),
                      axes, shape)


def mlstm_cell(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig, state=None):
    """x (B, S, d). Returns (y (B, S, d), the final state)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    q = _proj(ctx, x, cfg, "wq", d)
    # sqrt(hd) rounded to x's dtype, as the reference takes it (on the
    # host: a device scalar would cost a copy a call)
    scale = float(torch.tensor(hd, dtype=x.dtype).sqrt())
    k = _proj(ctx, x, cfg, "wk", d) / scale
    v = _proj(ctx, x, cfg, "wv", d)
    gates = _proj(ctx, x, cfg, "wgate", 3 * nh)
    i_pre, f_pre, o_pre = torch.chunk(gates.to(torch.float32), 3, dim=-1)
    f_pre = f_pre + 1.0  # forget-gate bias toward remembering

    def heads(t):  # (B, S, d) -> (B, S, H, hd)
        return t.reshape(b, s, nh, hd).to(torch.float32)

    qs, ks, vs = heads(q), heads(k), heads(v)
    sd = torch_dtype(cfg.rnn_state_dtype)
    if state is None:
        state = (torch.zeros((b, nh, hd, hd), dtype=sd, device=x.device),
                 torch.zeros((b, nh, hd), dtype=sd, device=x.device),
                 torch.full((b, nh), -math.inf, dtype=torch.float32,
                            device=x.device))
    else:
        state = (state[0].to(sd), state[1].to(sd), state[2])
    state, h = run_steps(_mlstm_step, state, (qs, ks, vs, i_pre, f_pre), s)
    state = (state[0].to(torch.float32), state[1].to(torch.float32),
             state[2])
    h = h.reshape(b, s, d)
    # jnp's ``repeat`` repeats each head's gate hd times in place: the
    # interleaving repeat, not Tensor.repeat's tiling
    h = h * torch.sigmoid(o_pre).repeat_interleave(hd, dim=-1)
    y = dense(ctx, "wo", h.to(x.dtype), cfg, axes=_OUT, shape=(d, d))
    return y, state


# ---------------------------------------------------------------------------
# sLSTM: scalar memory per unit, exponential gating, block-diag recurrence
# ---------------------------------------------------------------------------

def _slstm_step(state, z_x, i_x, f_x, o_x, *, r):
    """state: (c, n, m, h) each (B, H, hd); the input pre-activations of
    one step; ``r`` the f32 recurrent weights (H, hd, hd) by gate."""
    c, n, m, h_prev = state

    def rec(w):  # block-diagonal recurrent matmul per head
        return torch.einsum("bhi,hij->bhj", h_prev, w)

    z = torch.tanh(z_x + rec(r["z"]))
    i_pre = i_x + rec(r["i"])
    f_pre = f_x + rec(r["f"]) + 1.0
    o = torch.sigmoid(o_x + rec(r["o"]))
    m_new = torch.maximum(f_pre + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_pre + m - m_new)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = o * c / n.clamp(min=1.0)
    return (c, n, m_new, h), h


def slstm_cell(ctx: Ctx, x: torch.Tensor, cfg: ArchConfig, state=None):
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    zx, ix, fx, ox = (_proj(ctx, x, cfg, n, d)
                      for n in ("wz", "wi", "wf", "wo_in"))
    r = {nm: whole_param(ctx.param(f"r_{nm}"), ("heads", None, None),
                         (nh, hd, hd)) for nm in ("z", "i", "f", "o")}

    def heads(t):
        return t.reshape(b, s, nh, hd).to(torch.float32)

    if state is None:
        z0 = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        state = (z0, z0, torch.full((b, nh, hd), -math.inf,
                                    dtype=torch.float32, device=x.device), z0)
    state, h = run_steps(functools.partial(_slstm_step, r=r), state,
                         (heads(zx), heads(ix), heads(fx), heads(ox)), s)
    h = h.reshape(b, s, d).to(x.dtype)
    y = dense(ctx, "w_down", h, cfg, axes=_OUT, shape=(d, d))
    return y, state


# ---------------------------------------------------------------------------
# Blocks + model
# ---------------------------------------------------------------------------

def xlstm_block(ctx: Ctx, cfg: ArchConfig, x, *, kind: str, state=None):
    cell = mlstm_cell if kind == "mlstm" else slstm_cell
    with ctx.scope(kind):
        h, new_state = cell(ctx, norm(ctx, "ln", x, cfg), cfg, state=state)
    return x + h, new_state


_CELL_SITES = {
    "mlstm": ("wq", "wk", "wv", "wgate", "wo"),
    "slstm": ("wz", "wi", "wf", "wo_in", "w_down"),
}


def xlstm_block_sites(kinds, i: int):
    kind = kinds[i]
    return [(f"xlstm/layer_{i}/{kind}/{n}", OpKind.DENSE)
            for n in _CELL_SITES[kind]]


def _store(dst, src) -> None:
    """Write a layer's new state into its rows of the cache (views)."""
    for view, t in zip(dst, src):
        view.copy_(t)


class XLSTMModel:
    """One sLSTM block per ``slstm_every`` blocks (xLSTM[7:1] for 1.3B),
    mLSTM otherwise: ``forward``, ``init_cache`` and ``decode_step``.
    ``device`` is where :meth:`init` and :meth:`init_cache` allocate; it
    defaults to the card."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family != "ssm":
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} "
                                      "is not an xLSTM")
        self.cfg = cfg
        self.device = resolve_device(device)
        every = cfg.slstm_every or (cfg.n_layers + 1)
        self.kinds = ["slstm" if (i + 1) % every == 0 else "mlstm"
                      for i in range(cfg.n_layers)]
        self.n_m = self.kinds.count("mlstm")
        self.n_s = self.kinds.count("slstm")
        self.segments = plan_segments(
            cfg.approx_policy,
            functools.partial(xlstm_block_sites, self.kinds),
            0, cfg.n_layers)

    def param_specs(self) -> Dict[str, tuple]:
        """``{path: (shape, dtype, init)}`` with the JAX package's paths."""
        cfg = self.cfg
        d, pd = cfg.d_model, cfg.param_dtype
        nh = cfg.n_heads
        hd = d // nh
        specs = lm_specs(cfg)
        block_specs(specs, cfg, "mlstm_blocks", max(self.n_m, 1), "mlstm",
                    "ln", [(w, (d, n), pd, False, ax) for w, n, ax in
                           (("wq", d, _IN), ("wk", d, _IN), ("wv", d, _IN),
                            ("wgate", 3 * nh, _IN), ("wo", d, _OUT))])
        if self.n_s:
            block_specs(specs, cfg, "slstm_blocks", self.n_s, "slstm", "ln",
                        [(w, (d, d), pd, False,
                          _OUT if w == "w_down" else _IN) for w in
                         ("wz", "wi", "wf", "wo_in", "w_down")])
            for r in ("r_z", "r_i", "r_f", "r_o"):
                specs[f"slstm_blocks/slstm/{r}"] = ParamSpec(
                    (self.n_s, nh, hd, hd), "float32", normal_init(),
                    ("layers", "heads", None, None))
        return specs

    def init(self, seed: int = 0) -> Params:
        """Random parameters on ``self.device`` from a ``torch.Generator``
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_specs(), gen, self.device)

    def param_axes(self):
        """Each parameter's logical axes, as a tree like the params'."""
        return axes_tree(self.param_specs())

    def _run(self, params: Params, x, states=None):
        """The blocks in kind order: each run of mLSTM blocks through the
        policy segments (its stack's rows relative to ``base``), then one
        sLSTM block under ``xlstm/layer_{i}``. ``states`` (decode) holds the
        stacked states, written in place."""
        cfg = self.cfg

        def m_fn(c, xx, cache=None):
            xx, st = xlstm_block(c, cfg, xx, kind="mlstm", state=cache)
            if cache is not None:
                _store(cache, st)
            return xx, None, 0.0

        mp, sp = params["mlstm_blocks"], params.get("slstm_blocks")
        every = cfg.slstm_every or (cfg.n_layers + 1)
        group = every - 1  # mlstm blocks per slstm
        mi = si = i = 0
        while i < cfg.n_layers:
            n_m_here = min(group if self.n_s else cfg.n_layers, self.n_m - mi)
            if n_m_here > 0:
                with site_scope("xlstm"):
                    x, _ = run_policy_segments(
                        m_fn, mp, x,
                        segments=clip_segments(self.segments, i,
                                               i + n_m_here),
                        base=i - mi,
                        cache=None if states is None else states["mlstm"],
                        remat=cfg.remat if states is None else "none")
                mi += n_m_here
                i += n_m_here
            if self.n_s and si < self.n_s and i < cfg.n_layers:
                st = (None if states is None
                      else layer_slice(states["slstm"], si))
                with site_scope("xlstm"), site_scope(f"layer_{i}"):
                    x, nst = xlstm_block(Ctx(layer_slice(sp, si)), cfg, x,
                                         kind="slstm", state=st)
                if st is not None:
                    _store(st, nst)
                si += 1
                i += 1
        return x

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]):
        """tokens (B, S) -> (logits (B, S, V), aux 0.0)."""
        ctx = Ctx(params)
        tokens = batch["tokens"]
        x = embed(ctx, tokens, self.cfg)
        x = self._run(params, x)
        x = norm(ctx, "final_ln", x, self.cfg)
        with site_scope("xlstm"):
            logits = unembed(ctx, x, self.cfg)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)

    def init_cache(self, batch_size: int, max_seq: int):
        """The recurrent states on ``self.device``, f32: ``mlstm`` (C, n,
        m) and ``slstm`` (c, n, m, h), each stacked over its blocks, the
        stabilisers ``m`` at -inf; ``pos`` an int32 scalar. ``max_seq`` is
        unused (the state does not grow). Every leaf is its own tensor: the
        cache is written in place."""
        cfg = self.cfg
        nh = cfg.n_heads
        hd = cfg.d_model // nh

        def mk(shape, fill=0.0):
            return torch.full(shape, fill, dtype=torch.float32,
                              device=self.device)

        cache = {
            "mlstm": (mk((self.n_m, batch_size, nh, hd, hd)),
                      mk((self.n_m, batch_size, nh, hd)),
                      mk((self.n_m, batch_size, nh), -math.inf)),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        if self.n_s:
            shape = (self.n_s, batch_size, nh, hd)
            cache["slstm"] = (mk(shape), mk(shape), mk(shape, -math.inf),
                              mk(shape))
        return cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache):
        """tokens (B, 1). Returns (logits (B, 1, V), the cache with ``pos``
        advanced by one; its states are written in place)."""
        ctx = Ctx(params)
        x = embed(ctx, tokens, self.cfg)
        states = {k: v for k, v in cache.items() if k != "pos"}
        x = self._run(params, x, states=states)
        x = norm(ctx, "final_ln", x, self.cfg)
        with site_scope("xlstm"):
            logits = unembed(ctx, x, self.cfg)
        return logits, dict(states, pos=cache["pos"] + 1)
