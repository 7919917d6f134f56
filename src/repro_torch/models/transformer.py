"""Decoder-only transformer (dense, MoE, VLM): ``forward``, slot-cache
generation and paged serving steps; the Whisper encoder-decoder
(``EncDecLM``).

Parameters are the JAX package's tree: stacked ``blocks`` tensors with a
leading layer axis (and, for a VLM, stacked ``cross_blocks``). The
reference consumes the stack with one ``lax.scan`` per policy segment;
here each segment is a Python loop over its layers, run under the site
scope ``layer_{lo}`` of its first layer, so per-depth rules resolve
exactly as they do in the reference.

Ported: ``init``, ``forward``, ``init_cache``/``prefill``/``decode_step``
(slot caches, ring buffers), ``init_paged_cache``, ``paged_step`` and
``paged_verify_step``; MoE FFNs (``models/moe.py``, the load-balance aux
summed over layers) and a VLM's cross-attention blocks (a group of
``cross_every`` self blocks, then cross block ``g`` under the site scope
``cross_{g}``); ``EncDecLM``'s ``encode``, ``forward``, ``init_cache`` and
``decode_step``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.core.config import torch_dtype
from repro_torch.parallel.sharding import current_sharder, use_sharder
from repro_torch.policy import OpKind, plan_segments, site_scope
from repro_torch.policy.sites import scope_snapshot, use_scope
from repro_torch.runtime import trace
from repro_torch.runtime.device import resolve_device

from .common import ArchConfig
from .layers import (ATTN_AXES, FFN_AXES, cross_attention, embed,
                     mlp, norm, self_attention, unembed, whole_param)
from .module import (Ctx, ParamSpec, axes_tree, init_params, layer_slice,
                     lecun_init, normal_init, ones_init, zeros_init)
from .moe import EXPERT_IN_AXES, EXPERT_OUT_AXES, moe_ffn

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Op-site probes (policy segmentation)
# ---------------------------------------------------------------------------

def mlp_sites(cfg: ArchConfig, base: str):
    """(path, kind) probe sites of one dense MLP under ``base``."""
    names = ("wi", "wg", "wo") if cfg.act in ("swiglu", "geglu") else \
        ("wi", "wo")
    return [(f"{base}/{n}", OpKind.DENSE) for n in names]


def attn_sites(base: str):
    sites = [(f"{base}/{n}", OpKind.DENSE) for n in ("wq", "wk", "wv", "wo")]
    # the dynamic qk^T/att@v contraction pair resolves as one ATTN_QK site
    sites.append((f"{base}/kernel", OpKind.ATTN_QK))
    return sites


def decoder_block_sites(cfg: ArchConfig, i: int, prefix: str = "decoder"):
    """Every contraction site of decoder layer ``i``: the paths the block
    produces (Ctx scopes + dense leaf names)."""
    base = f"{prefix}/layer_{i}"
    sites = attn_sites(f"{base}/attn")
    if cfg.n_experts:
        names = ("w_in", "w_gate", "w_out") if cfg.act in ("swiglu", "geglu") \
            else ("w_in", "w_out")
        sites += [(f"{base}/ffn/{n}", OpKind.MOE_EXPERT) for n in names]
    else:
        sites += mlp_sites(cfg, f"{base}/ffn")
    return sites


def clip_segments(segments, lo: int, hi: int):
    """Intersect policy segments with the layer range [lo, hi)."""
    return tuple((max(a, lo), min(b, hi))
                 for a, b in segments if a < hi and b > lo)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def decoder_block(ctx: Ctx, cfg: ArchConfig, x, *, positions, cache=None,
                  causal=True):
    """Pre-norm self-attention + FFN (dense or MoE). Returns (x, cache,
    aux): the MoE load-balance loss, 0.0 for a dense FFN."""
    use_bias = cfg.norm == "layernorm"  # starcoder2/whisper-style
    with ctx.scope("attn"), trace.span("model.attn", annotate=False):
        h, new_cache = self_attention(
            ctx, norm(ctx, "ln1", x, cfg), cfg, positions=positions,
            cache=cache, causal=causal, use_bias=use_bias)
    x = x + h
    aux = 0.0
    with ctx.scope("ffn"), trace.span("model.ffn", annotate=False):
        y = norm(ctx, "ln2", x, cfg)
        if cfg.n_experts:
            h, aux = moe_ffn(ctx, y, cfg)
        else:
            h = mlp(ctx, y, cfg, use_bias=use_bias)
    return x + h, new_cache, aux


def cross_block(ctx: Ctx, cfg: ArchConfig, x, kv_src):
    """Cross-attention block (VLM / whisper decoder insert)."""
    with ctx.scope("xattn"), trace.span("model.xattn", annotate=False):
        h = cross_attention(ctx, norm(ctx, "ln1", x, cfg), kv_src, cfg)
    x = x + h
    with ctx.scope("ffn"), trace.span("model.ffn", annotate=False):
        x = x + mlp(ctx, norm(ctx, "ln2", x, cfg), cfg)
    return x


REMAT_MODES = ("none", "dots", "dots_nb", "full")
# the exact matmuls "dots" saves (the reference's checkpoint_dots: every
# dot_general) and "dots_nb" (checkpoint_dots_with_no_batch_dims: the
# unbatched ones, the weight GEMMs)
_DOTS = {"dots": ("mm", "addmm", "bmm", "baddbmm", "matmul"),
         "dots_nb": ("mm", "addmm")}


def _save_dots(names, ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    name = getattr(op, "_overloadpacket", op).__name__
    return (CheckpointPolicy.MUST_SAVE if name in names
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_remat(fn, remat: str):
    """``fn`` under the reference's activation-checkpoint policy
    (``torch.utils.checkpoint``, non-reentrant; the values do not change):

    * ``"none"``: ``fn`` itself;
    * ``"dots"``: saves the outputs of every exact matmul (``aten.mm``,
      ``addmm``, ``bmm``, ``matmul``; the attention scores too) and
      recomputes the rest (selective checkpointing);
    * ``"dots_nb"``: saves only the unbatched ones (``mm``, ``addmm``: the
      weight GEMMs); the attention scores are recomputed;
    * ``"full"``: saves nothing, recomputes everything.

    A hand-written kernel (the DAISM GEMM, flash) is no aten matmul, as a
    ``pallas_call`` is no ``dot_general``: every mode recomputes it, as
    the reference's does. The recompute runs under the site scopes and the
    sharder of the forward. Any other string raises."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_MODES}")
    if remat == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    kw = {}
    if remat in _DOTS:
        policy = functools.partial(_save_dots, _DOTS[remat])
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def wrapped(*args):
        scope, sharder = scope_snapshot(), current_sharder()

        def run(*a):
            with use_scope(scope), use_sharder(sharder):
                return fn(*a)

        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return wrapped


def run_policy_segments(layer_fn, stacked_params: Params, x, *, segments,
                        base: int = 0, cache: Optional[Params] = None,
                        prefix: str = "layer", remat: str = "none"):
    """Run ``x`` through the layer stack, segment by segment; returns (x,
    the sum of the layers' aux losses).

    ``segments`` are (lo, hi) *global* layer ranges (plan_segments); the
    stacked params and cache are indexed relative to ``base``, the global
    index of their row 0 (an xLSTM's mLSTM stack holds only some of the
    layers). Each segment runs under the site scope ``{prefix}_{lo}`` —
    per-depth rules resolve against its first layer, as in the reference's
    segmented scans — with one ``layer_fn(ctx, x, cache)`` call per layer
    on that layer's row of the stacked params (and of the stacked cache,
    whose rows are views, so in-place updates land in the caller's cache),
    each under :func:`apply_remat` ``remat``.
    """
    layer = apply_remat(lambda p, h, c: layer_fn(Ctx(p), h, c), remat)
    aux = 0.0
    for lo, hi in segments:
        with site_scope(f"{prefix}_{lo}", repeat=hi - lo):
            for i in range(lo - base, hi - base):
                c = None if cache is None else layer_slice(cache, i)
                x, _, a = layer(layer_slice(stacked_params, i), x, c)
                aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Parameter specs shared by the language models
# ---------------------------------------------------------------------------

def lm_specs(cfg: ArchConfig) -> Dict[str, tuple]:
    """The embedding, the final norm and (untied) the lm_head."""
    d, pd = cfg.d_model, cfg.param_dtype
    specs: Dict[str, tuple] = {
        "embedding": ParamSpec((cfg.vocab, d), pd, normal_init(1.0),
                               ("vocab", "embed")),
        "final_ln_scale": ParamSpec((d,), "float32", ones_init(),
                                    ("act_embed",)),
    }
    if cfg.norm == "layernorm":
        specs["final_ln_bias"] = ParamSpec((d,), "float32", zeros_init(),
                                           ("act_embed",))
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, cfg.vocab), pd, lecun_init(),
                                     ("embed", "vocab"))
    return specs


def block_specs(specs: Dict[str, tuple], cfg: ArchConfig, stack: str,
                n: Optional[int], scope: str, ln: str, mats) -> None:
    """Add one block scope's norm ``ln`` and matrices ``mats`` (name, shape,
    dtype, bias, logical axes) under ``{stack}/{scope}``, stacked ``n`` deep
    on a ``layers`` axis (``None``: a single block, as Zamba's shared
    one). A bias takes its matrix's output axis."""
    lead, lax_ = ((), ()) if n is None else ((n,), ("layers",))
    d, pre = cfg.d_model, f"{stack}/{scope}"
    specs[f"{pre}/{ln}_scale"] = ParamSpec((*lead, d), "float32",
                                           ones_init(), (*lax_, "act_embed"))
    if cfg.norm == "layernorm":
        specs[f"{pre}/{ln}_bias"] = ParamSpec(
            (*lead, d), "float32", zeros_init(), (*lax_, "act_embed"))
    for name, shape, dtype, bias, axes in mats:
        specs[f"{pre}/{name}"] = ParamSpec((*lead, *shape), dtype,
                                           lecun_init(), (*lax_, *axes))
        if bias:
            specs[f"{pre}/{name}_b"] = ParamSpec(
                (*lead, shape[-1]), cfg.param_dtype, zeros_init(),
                (*lax_, axes[-1]))


def attn_mats(cfg: ArchConfig, bias: bool):
    d, pd = cfg.d_model, cfg.param_dtype
    return [("wq", (d, cfg.q_dim), pd, bias, ATTN_AXES["wq"]),
            ("wk", (d, cfg.kv_dim), pd, bias, ATTN_AXES["wk"]),
            ("wv", (d, cfg.kv_dim), pd, bias, ATTN_AXES["wv"]),
            ("wo", (cfg.q_dim, d), pd, bias, ATTN_AXES["wo"])]


def ffn_mats(cfg: ArchConfig, bias: bool):
    d, pd = cfg.d_model, cfg.param_dtype
    gated = cfg.act in ("swiglu", "geglu")
    return ([("wi", (d, cfg.d_ff), pd, bias, FFN_AXES["wi"])]
            + ([("wg", (d, cfg.d_ff), pd, False, FFN_AXES["wg"])]
               if gated else [])
            + [("wo", (cfg.d_ff, d), pd, bias, FFN_AXES["wo"])])


# ---------------------------------------------------------------------------
# Decoder-only LM (dense + MoE + VLM)
# ---------------------------------------------------------------------------

class DecoderLM:
    """Dense / MoE / VLM decoder LM: ``init``, ``forward``, slot-cache
    generation and the paged serving steps (not for a VLM, as in the
    reference).

    ``device`` is where :meth:`init`, :meth:`init_cache` and
    :meth:`init_paged_cache` allocate; it defaults to the card.
    """

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not a decoder-only "
                "transformer ported to DecoderLM")
        self.cfg = cfg
        self.is_vlm = cfg.cross_every > 0
        self.device = resolve_device(device)
        # maximal layer runs with identical resolved numerics
        self.segments = plan_segments(
            cfg.approx_policy,
            functools.partial(decoder_block_sites, cfg), 0, cfg.n_layers)

    @property
    def n_cross(self) -> int:
        return self.cfg.n_layers // self.cfg.cross_every if self.is_vlm else 0

    # -- init ------------------------------------------------------------
    def param_specs(self) -> Dict[str, tuple]:
        """``{path: (shape, dtype, init)}`` of every parameter, with the JAX
        package's key paths and shapes."""
        cfg = self.cfg
        L = cfg.n_layers
        specs = lm_specs(cfg)
        use_bias = cfg.norm == "layernorm"
        block_specs(specs, cfg, "blocks", L, "attn", "ln1",
                    attn_mats(cfg, use_bias))
        if cfg.n_experts:
            d, pd = cfg.d_model, cfg.param_dtype
            e, ff = cfg.n_experts, cfg.expert_ff
            gated = cfg.act in ("swiglu", "geglu")
            block_specs(specs, cfg, "blocks", L, "ffn", "ln2",
                        [("router", (d, e), "float32", False,
                          ("embed", None)),
                         ("w_in", (e, d, ff), pd, False, EXPERT_IN_AXES)]
                        + ([("w_gate", (e, d, ff), pd, False,
                             EXPERT_IN_AXES)] if gated else [])
                        + [("w_out", (e, ff, d), pd, False,
                            EXPERT_OUT_AXES)])
        else:
            block_specs(specs, cfg, "blocks", L, "ffn", "ln2",
                        ffn_mats(cfg, use_bias))
        if self.is_vlm:  # cross blocks carry no biases
            block_specs(specs, cfg, "cross_blocks", self.n_cross, "xattn",
                        "ln1", attn_mats(cfg, False))
            block_specs(specs, cfg, "cross_blocks", self.n_cross, "ffn",
                        "ln2", ffn_mats(cfg, False))
        return specs

    def init(self, seed: int = 0) -> Params:
        """Random parameters on ``self.device`` from a ``torch.Generator``
        seeded with ``seed``.

        (The JAX package's ``jax.random`` draws cannot be reproduced here;
        tests carry its parameters across with ``convert.params_from_jax``.)
        """
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_specs(), gen, self.device)

    def param_axes(self) -> Params:
        """Each parameter's logical axes, as a tree like the params'."""
        return axes_tree(self.param_specs())

    def _layers(self, params: Params, x, layer_fn, cache=None,
                image_embeds=None, remat: str = "none"):
        """The layer stack under the ``decoder`` scope: the policy segments
        in one run, or for a VLM in groups of ``cross_every`` layers, each
        followed by its cross block against ``image_embeds``, every block
        under ``remat`` (``apply_remat``). Returns (x, the summed aux loss:
        a tensor for an MoE, else 0.0)."""
        cfg = self.cfg
        if not self.is_vlm:
            x, aux = run_policy_segments(layer_fn, params["blocks"], x,
                                         segments=self.segments, cache=cache,
                                         remat=remat)
        else:
            img = image_embeds.to(x.dtype)
            per, aux = cfg.cross_every, 0.0
            cross = apply_remat(
                lambda cp, h: cross_block(Ctx(cp), cfg, h, img), remat)
            for g in range(self.n_cross):
                x, a = run_policy_segments(
                    layer_fn, params["blocks"], x, cache=cache,
                    segments=clip_segments(self.segments, g * per,
                                           (g + 1) * per), remat=remat)
                aux = aux + a
                with site_scope(f"cross_{g}"):
                    x = cross(layer_slice(params["cross_blocks"], g), x)
        return x, aux

    # -- forward (train / prefill) ----------------------------------------
    def forward(self, params: Params, batch: Dict[str, torch.Tensor]):
        """tokens (B, S) (and, for a VLM, ``image_embeds`` (B, N, d)) ->
        (logits (B, S, V), aux: the MoE load-balance loss summed over the
        layers, 0.0 without experts)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        positions = torch.arange(s, device=tokens.device)
        ctx = Ctx(params)

        def layer_fn(c, xx, cache=None):
            return decoder_block(c, cfg, xx, positions=positions, causal=True)

        with site_scope("decoder"):
            x = embed(ctx, tokens, cfg)
            x, aux = self._layers(params, x, layer_fn,
                                  image_embeds=batch.get("image_embeds"),
                                  remat=cfg.remat)
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        if not torch.is_tensor(aux):  # no experts: the reference's 0.0
            aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return logits, aux

    # -- KV cache ----------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int):
        """A slot cache on ``self.device``: ``k``/``v`` (layers, B, size, KH,
        HD) zeros in the compute dtype and ``pos`` an int32 scalar 0. A
        window shorter than ``max_seq`` makes it a ring buffer of ``window``
        cells, with ``abs_pos`` (layers, size), the absolute position of each
        cell, -1 while empty."""
        cfg = self.cfg
        ring = bool(cfg.window) and cfg.window < max_seq
        size = min(cfg.window, max_seq) if ring else max_seq
        kshape = (cfg.n_layers, batch_size, size, cfg.kv_heads, cfg.head_dim)
        dt = torch_dtype(cfg.compute_dtype)
        cache = {
            "k": torch.zeros(kshape, dtype=dt, device=self.device),
            "v": torch.zeros(kshape, dtype=dt, device=self.device),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        if ring:
            cache["abs_pos"] = torch.full((cfg.n_layers, size), -1,
                                          dtype=torch.int32,
                                          device=self.device)
        return cache

    def _cached_forward(self, params: Params, tokens: torch.Tensor, cache,
                        positions, pos, image_embeds=None):
        """Embed -> cached layer stack -> logits. ``positions`` feeds rope
        and attention masking; ``pos`` is the cache write offset, a scalar
        (shared) or a (B,) vector (per-slot cache). The cache's ``k``/``v``
        (and ``abs_pos``) are written in place; returns (logits, those
        leaves). A VLM's cross blocks attend to ``image_embeds``."""
        cfg = self.cfg
        ctx = Ctx(params)
        layer_cache = {"k": cache["k"], "v": cache["v"]}
        if "abs_pos" in cache:
            layer_cache["abs_pos"] = cache["abs_pos"]

        def layer_fn(c, xx, lc=None):
            return decoder_block(c, cfg, xx, positions=positions,
                                 cache=dict(lc, pos=pos), causal=True)

        with site_scope("decoder"):
            x = embed(ctx, tokens, cfg)
            x, _ = self._layers(params, x, layer_fn, cache=layer_cache,
                                image_embeds=image_embeds)
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        return logits, layer_cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache,
                    image_embeds: Optional[torch.Tensor] = None):
        """tokens (B, 1). Returns (logits (B, 1, V), the cache with ``pos``
        advanced by one).

        ``cache['pos']`` is a scalar (every row at one offset) or a (B,)
        vector (a slot cache: row ``i`` is an independent request at offset
        ``pos[i]``). The cache's tensors are written in place (the reference
        donates them to its jit'd step instead)."""
        pos = cache["pos"]
        positions = pos[:, None] if pos.dim() == 1 else pos.reshape(1)
        logits, new_lc = self._cached_forward(params, tokens, cache,
                                              positions, pos, image_embeds)
        return logits, dict(new_lc, pos=pos + 1)

    def prefill(self, params: Params, tokens: torch.Tensor, cache,
                image_embeds: Optional[torch.Tensor] = None):
        """Batched prompt ingestion: one forward writes the prompt K/V into
        the cache and returns full logits. tokens (B, S); right-padded
        prompts are fine (a pad entry is overwritten by decode before its
        position is reached, or masked causally).

        Returns (logits (B, S, V), the cache with ``pos`` advanced by S).
        Ring caches and per-slot ``pos`` vectors are refused, as in the
        reference."""
        if "abs_pos" in cache:
            raise NotImplementedError(
                "prefill does not support ring/window caches")
        pos = cache["pos"]
        if pos.dim() != 0:
            raise ValueError("prefill expects a scalar-pos cache")
        s = tokens.shape[1]
        positions = pos + torch.arange(s, device=pos.device)
        logits, new_lc = self._cached_forward(params, tokens, cache,
                                              positions, pos, image_embeds)
        return logits, dict(new_lc, pos=pos + s)

    # -- paged KV cache (block tables; repro_torch.serve) --------------------
    def init_paged_cache(self, num_blocks: int, block_size: int):
        """Physical page pool ``k/v (layers, num_blocks*block_size + 1, KH,
        HD)`` on ``self.device``. The extra last cell is the sink that
        absorbs dropped writes (see ``layers._paged_kv_attend``). Under a
        sharder, KH is this rank's kv heads (:meth:`paged_cache_axes`)."""
        cfg = self.cfg
        if cfg.window:
            raise ValueError(
                f"paged KV cache needs window=0 (got window={cfg.window}: "
                "ring buffers roll in place, pages are freed whole)")
        if self.is_vlm:
            raise NotImplementedError(
                "paged serving does not cover VLM cross-attention blocks")
        cells = num_blocks * block_size
        kshape = (cfg.n_layers, cells, cfg.kv_heads, cfg.head_dim)
        sharder = current_sharder()
        if sharder is not None:
            kshape = sharder.local_shape(
                kshape, sharder.spec(self.paged_cache_axes(), kshape))
        kshape = (kshape[0], cells + 1, *kshape[2:])
        dt = torch_dtype(cfg.compute_dtype)
        return {"k": torch.zeros(kshape, dtype=dt, device=self.device),
                "v": torch.zeros(kshape, dtype=dt, device=self.device)}

    @staticmethod
    def paged_cache_axes():
        """Logical axes of each paged-pool leaf (``init_paged_cache`` k/v):
        layers and pool cells stay whole on every rank, kv heads split over
        the model axis, the same split as the rank's q heads, so the
        block-table gather/scatter is always rank-local."""
        return ("layers", None, "act_kv_heads", None)

    def paged_step(self, params: Params, tokens: torch.Tensor, cache, *,
                   block_size: int):
        """One fixed-shape step over block tables: decode (S=1) and chunked
        prefill (S=chunk).

        tokens (B, S); cache holds the physical pools ``k/v`` from
        :meth:`init_paged_cache` plus ``block_tables`` (B, MB) int32 page ids
        (-1 = unmapped) and ``pos`` (B,), each row's write offset. Row ``i``
        writes K/V for positions ``pos[i] .. pos[i]+S-1`` through its table
        and attends over its own gathered pages; writes outside the mapped
        pages are dropped and unmapped reads are causally masked.

        The pools are updated in place (the reference donates them to its
        jit'd step instead). Returns ``(logits (B, S, V), {k, v})``.
        """
        cfg = self.cfg
        bt, pos = cache["block_tables"].long(), cache["pos"].long()
        b, s = tokens.shape
        mb = bt.shape[1]
        cells = cache["k"].shape[1] - 1  # last cell: the drop sink
        dev = tokens.device
        positions = pos[:, None] + torch.arange(s, device=dev)  # (B, S)
        # physical cell of every logical kv position (B, MB*block_size)
        base = torch.where(bt < 0, cells, bt * block_size)
        phys_read = (base[:, :, None] + torch.arange(block_size, device=dev)
                     ).reshape(b, mb * block_size)
        # physical cell of each written token; == cells means "drop"
        lblk = positions // block_size
        wblk = torch.take_along_dim(bt, lblk.clamp(max=mb - 1), dim=1)
        write_idx = torch.where((wblk < 0) | (lblk >= mb), cells,
                                wblk * block_size + positions % block_size)

        ctx = Ctx(params)
        pool = {"k": cache["k"], "v": cache["v"]}

        def layer_fn(c, xx, lc=None):
            lc = dict(lc, write_idx=write_idx, phys_read=phys_read)
            return decoder_block(c, cfg, xx, positions=positions, cache=lc,
                                 causal=True)

        with site_scope("decoder"):
            x = embed(ctx, tokens, cfg)
            x, _ = run_policy_segments(layer_fn, params["blocks"], x,
                                       segments=self.segments, cache=pool)
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        return logits, pool

    def paged_verify_step(self, params: Params, tokens: torch.Tensor, cache,
                          *, block_size: int):
        """Speculative-decoding verify: one :meth:`paged_step` over the
        ``S = k+1`` candidate positions. ``tokens[:, 0]`` is each row's last
        committed token, ``tokens[:, 1:]`` the ``k`` drafts.

        Returns ``(greedy (B, S) per-position argmax, n_acc (B,) the longest
        prefix of drafts that greedy agrees with, {k, v})``; the caller
        emits ``greedy[:, :n_acc+1]`` and rolls back the rest."""
        logits, new_kv = self.paged_step(params, tokens, cache,
                                         block_size=block_size)
        greedy = torch.argmax(logits, -1)                     # (B, S)
        match = (greedy[:, :-1] == tokens[:, 1:]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)        # (B,)
        return greedy, n_acc, new_kv


# ---------------------------------------------------------------------------
# Encoder-decoder (the Whisper backbone; the conv/audio frontend is a stub,
# as in the reference: batches carry precomputed frame embeddings)
# ---------------------------------------------------------------------------

def encoder_block(ctx: Ctx, cfg: ArchConfig, x, *, positions, cache=None):
    """Bidirectional self-attention + MLP, both with biases."""
    with ctx.scope("attn"), trace.span("model.attn", annotate=False):
        h, _ = self_attention(ctx, norm(ctx, "ln1", x, cfg), cfg,
                              positions=positions, causal=False,
                              use_bias=True)
    x = x + h
    with ctx.scope("ffn"), trace.span("model.ffn", annotate=False):
        x = x + mlp(ctx, norm(ctx, "ln2", x, cfg), cfg, use_bias=True)
    return x, None, 0.0


def encdec_decoder_block(ctx: Ctx, cfg: ArchConfig, x, *, positions,
                         enc_kv, cache=None):
    """Causal self-attention (slot-cached in ``decode_step``), cross
    attention to the encoder states, MLP; every GEMM with a bias."""
    with ctx.scope("attn"), trace.span("model.attn", annotate=False):
        h, new_cache = self_attention(ctx, norm(ctx, "ln1", x, cfg), cfg,
                                      positions=positions, cache=cache,
                                      causal=True, use_bias=True)
    x = x + h
    with ctx.scope("xattn"), trace.span("model.xattn", annotate=False):
        h = cross_attention(ctx, norm(ctx, "lnx", x, cfg), enc_kv, cfg,
                            use_bias=True)
    x = x + h
    with ctx.scope("ffn"), trace.span("model.ffn", annotate=False):
        x = x + mlp(ctx, norm(ctx, "ln2", x, cfg), cfg, use_bias=True)
    return x, new_cache, 0.0


def encoder_block_sites(cfg: ArchConfig, i: int):
    base = f"encoder/layer_{i}"
    return attn_sites(f"{base}/attn") + mlp_sites(cfg, f"{base}/ffn")


def encdec_decoder_sites(cfg: ArchConfig, i: int):
    base = f"decoder/layer_{i}"
    return (attn_sites(f"{base}/attn") + attn_sites(f"{base}/xattn")
            + mlp_sites(cfg, f"{base}/ffn"))


class EncDecLM:
    """Whisper-style: a transformer encoder over precomputed frame
    embeddings (plus the learned ``enc_pos``), a causal decoder with no
    positional embedding and cross attention in every layer.

    ``decode_step`` recomputes the cross-attention K/V from ``cache['enc']``
    at every step, as the reference does (it keeps no cross-KV cache).
    ``device`` is where :meth:`init` and :meth:`init_cache` allocate; it
    defaults to the card.
    """

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family != "audio":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not an "
                "encoder-decoder")
        self.cfg = cfg
        self.device = resolve_device(device)
        pol = cfg.approx_policy
        self.enc_segments = plan_segments(
            pol, functools.partial(encoder_block_sites, cfg), 0,
            cfg.enc_layers)
        self.dec_segments = plan_segments(
            pol, functools.partial(encdec_decoder_sites, cfg), 0,
            cfg.n_layers)

    def param_specs(self) -> Dict[str, tuple]:
        """``{path: (shape, dtype, init)}`` with the JAX package's paths."""
        cfg = self.cfg
        specs = lm_specs(cfg)
        specs["enc_pos"] = ParamSpec((cfg.enc_frames, cfg.d_model),
                                     cfg.param_dtype, normal_init(),
                                     ("frames", "embed"))
        E, L = cfg.enc_layers, cfg.n_layers
        block_specs(specs, cfg, "enc_blocks", E, "attn", "ln1",
                    attn_mats(cfg, True))
        block_specs(specs, cfg, "enc_blocks", E, "ffn", "ln2",
                    ffn_mats(cfg, True))
        block_specs(specs, cfg, "dec_blocks", L, "attn", "ln1",
                    attn_mats(cfg, True))
        block_specs(specs, cfg, "dec_blocks", L, "xattn", "lnx",
                    attn_mats(cfg, True))
        block_specs(specs, cfg, "dec_blocks", L, "ffn", "ln2",
                    ffn_mats(cfg, True))
        return specs

    def init(self, seed: int = 0) -> Params:
        """Random parameters on ``self.device`` from a ``torch.Generator``
        seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_specs(), gen, self.device)

    def param_axes(self) -> Params:
        """Each parameter's logical axes, as a tree like the params'."""
        return axes_tree(self.param_specs())

    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, enc_frames, d) -> encoder states, compute dtype."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        pos = whole_param(params["enc_pos"], ("frames", "embed"),
                         (cfg.enc_frames, cfg.d_model))
        x = frames.to(dt) + pos.to(dt)
        positions = torch.arange(frames.shape[1], device=frames.device)

        def enc_fn(c, xx, cache=None):
            return encoder_block(c, cfg, xx, positions=positions)

        with site_scope("encoder"):
            x, _ = run_policy_segments(enc_fn, params["enc_blocks"], x,
                                       segments=self.enc_segments,
                                       remat=cfg.remat)
        return x

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]):
        """tokens (B, S) and frames (B, enc_frames, d) -> (logits (B, S, V),
        aux 0.0)."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        ctx = Ctx(params)

        def dec_fn(c, xx, cache=None):
            return encdec_decoder_block(c, cfg, xx, positions=positions,
                                        enc_kv=enc)

        with site_scope("decoder"):
            x = embed(ctx, tokens, cfg)
            x, _ = run_policy_segments(dec_fn, params["dec_blocks"], x,
                                       segments=self.dec_segments,
                                       remat=cfg.remat)
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)

    def init_cache(self, batch_size: int, max_seq: int):
        """The decoder's slot cache on ``self.device`` (``k``/``v`` (layers,
        B, max_seq, KH, HD), ``pos`` an int32 scalar) and ``enc`` (B,
        enc_frames, d) zeros: the caller fills it with :meth:`encode`."""
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        kshape = (cfg.n_layers, batch_size, max_seq, cfg.kv_heads,
                  cfg.head_dim)
        return {
            "k": torch.zeros(kshape, dtype=dt, device=self.device),
            "v": torch.zeros(kshape, dtype=dt, device=self.device),
            "enc": torch.zeros((batch_size, cfg.enc_frames, cfg.d_model),
                               dtype=dt, device=self.device),
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    def decode_step(self, params: Params, tokens: torch.Tensor, cache):
        """tokens (B, 1) at the scalar ``cache['pos']``, attending to
        ``cache['enc']``. Returns (logits (B, 1, V), the cache with ``pos``
        advanced by one); ``k``/``v`` are written in place."""
        cfg = self.cfg
        pos, enc = cache["pos"], cache["enc"]
        positions = pos.reshape(1)
        ctx = Ctx(params)

        def layer_fn(c, xx, lc=None):
            return encdec_decoder_block(c, cfg, xx, positions=positions,
                                        enc_kv=enc, cache=dict(lc, pos=pos))

        with site_scope("decoder"):
            x = embed(ctx, tokens, cfg)
            x, _ = run_policy_segments(
                layer_fn, params["dec_blocks"], x, segments=self.dec_segments,
                cache={"k": cache["k"], "v": cache["v"]})
            x = norm(ctx, "final_ln", x, cfg)
            logits = unembed(ctx, x, cfg)
        return logits, {"k": cache["k"], "v": cache["v"], "enc": enc,
                        "pos": pos + 1}
