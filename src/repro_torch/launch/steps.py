"""Builders for the train, prefill and decode steps, on one device or over a
mesh of ranks.

``build_artifacts(cfg, mesh=None)`` assembles, for one architecture, the
model, the sharder (the reference's logical-axis rules), the layout trees
and the step functions: the port of ``repro/launch/steps.py`` in eager
PyTorch (there is nothing to compile). As in the reference a sharder is
always installed: with ``mesh=None`` it is a sizes-only ``{"data": 1,
"model": 1}`` one that needs no process group, so an MoE id takes the
capacity-dropping expert-parallel FFN on one device, as the reference's
does on a 1x1 mesh, and a dense id computes what it computed without one.

* ``train_step(params, opt, batch) -> (params, opt, metrics)``: forward,
  ``lm_loss``, the backward pass, ``apply_updates`` with the cosine
  schedule. As in the reference, the schedule reads the optimizer's step
  *before* it is incremented, so the first step has ``lr_scale = 0`` and
  leaves the parameters as they were. The parameters and the optimizer
  state are updated in place (see ``optim/adamw.py``).
* ``prefill_step(params, batch) -> logits``: the full-sequence forward
  under ``torch.no_grad()``.
* ``decode_step(params, tokens, cache, extra=None) -> (logits, cache)``:
  one token through ``model.decode_step`` under ``torch.no_grad()`` (a
  VLM's ``extra`` is its ``image_embeds``), on a cache from
  ``init_cache(batch_size, max_seq)`` (allocated on the artifacts'
  device; the reference's ``make_cache_shapes`` gives the same tree
  abstractly): a slot cache, an encoder-decoder's with ``enc`` (the caller
  fills it with ``model.encode``), or the recurrent states of xLSTM and
  Zamba. The cache is written in place.

Under a mesh (``launch/mesh.py::make_mesh`` over a process group) every
rank holds its shards (``init_params``, ``init_opt``, ``restore`` with
``param_shardings`` / ``opt_shardings``) and its batch rows
(``data/synthetic.py::shard_batch`` with ``batch_sharding``). The train
step is the reference's global one: each data rank takes ``lm_loss`` on
its rows, the gradient is their mean (the FSDP gathers sum it over the
data ranks, leaves whole over ``data`` are all-reduced), the clip reads
the global norm, and the logged loss is the global batch's. Prefill and
decode take this rank's rows (a decode step on its shard of
``init_cache``: its rows, its kv heads) and give their logits over the
whole vocabulary. Every family is laid out over a mesh of any size; heads
that a ``model`` axis cuts inside are gathered and computed whole on every
rank (``models/layers.py``).

``device="meta"`` builds the same steps for a shape-only trace
(``launch/dryrun.py``): ``init_params`` gives this rank's shards as
``meta`` tensors, and under a sizes-only mesh (``{axis: size}``) the
collectives return the shapes a process group would (``parallel/
sharding.py``). ``rules`` replaces the reference's rule table
(``parallel.sharding.base_rules``).

Every family trains and prefills alike: an audio batch carries
``frames`` beside ``tokens`` and ``labels``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.config import torch_dtype
from repro_torch.models.common import ArchConfig
from repro_torch.models.convert import shard_params
from repro_torch.models.module import flatten, unflatten
from repro_torch.models.registry import build_model, lm_loss
from repro_torch.optim import (AdamWConfig, AdamWState, apply_updates,
                               cosine_with_warmup, init_state)
from repro_torch.parallel.sharding import (NamedSharding, Sharder,
                                           base_rules, mesh_axis_names,
                                           use_sharder)

# ---------------------------------------------------------------------------
# Cache logical axes (keyed by leaf name + rank: the reference's table)
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    ("k", 5): ("layers", "cache_batch", "cache_seq", "act_kv_heads", None),
    ("v", 5): ("layers", "cache_batch", "cache_seq", "act_kv_heads", None),
    ("k", 4): ("cache_batch", "cache_seq", "act_kv_heads", None),
    ("v", 4): ("cache_batch", "cache_seq", "act_kv_heads", None),
    ("abs_pos", 2): ("layers", "cache_seq"),
    ("abs_pos", 1): ("cache_seq",),
    ("conv", 4): ("layers", "cache_batch", None, "act_mlp"),
    ("ssm", 5): ("layers", "cache_batch", "act_heads", None, None),
    ("enc", 3): ("cache_batch", "frames", "act_embed"),
    ("pos", 0): (),
}


def cache_axes(cache, name: Optional[str] = None) -> Any:
    """The logical axes of every leaf of a cache tree (dicts and tuples),
    by the leaf's nearest dict key and its rank; a leaf the table does not
    name (xLSTM's state tuples) takes its rows over the batch axes after
    its stacked layer dim, as in the reference."""
    if isinstance(cache, dict):
        return {k: cache_axes(v, k) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(cache_axes(v, name) for v in cache)
    rank = cache.dim()
    if (name, rank) in _CACHE_AXES:
        return _CACHE_AXES[(name, rank)]
    if rank >= 2:
        return ("layers", "cache_batch") + (None,) * (rank - 2)
    return (None,) * rank


def _tree_map(fn, *trees):
    """``fn`` over the leaves of congruent trees of dicts and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        return tuple(_tree_map(fn, *x) for x in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Artifacts:
    cfg: ArchConfig
    mesh: Any                 # the DeviceMesh, or None (one device)
    sharder: Sharder
    model: Any
    param_axes: Any           # logical axes, a tree like the params'
    param_shardings: Any      # NamedSharding tree (global shapes' specs)
    opt_shardings: AdamWState
    train_step: Callable      # (params, opt, batch) -> (params, opt, metrics)
    prefill_step: Callable    # (params, batch) -> logits
    decode_step: Callable     # (params, tokens, cache[, extra]) -> (logits, cache)
    batch_sharding: Callable[[Any], Any]
    cache_shardings_for: Callable[[Any], Any]
    init_params: Callable[[int], Any]
    init_opt: Callable[[Any], AdamWState]
    init_cache: Callable[[int, int], Dict[str, torch.Tensor]]


def build_artifacts(cfg: ArchConfig, mesh=None, *, device="cuda",
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    rules: Optional[dict] = None,
                    total_steps: int = 100_000,
                    warmup: int = 1000) -> Artifacts:
    """The steps for ``cfg`` on ``device`` (default: the card; under a
    mesh, this rank's device; ``meta``: a shape-only trace), laid out over
    ``mesh`` (a named ``DeviceMesh``, or an ``{axis: size}`` dict for the
    sizes-only sharder; None: one device, under a sizes-only 1x1 one) by
    ``rules`` (default: ``base_rules`` for the mesh's axes)."""
    names = mesh_axis_names(mesh) if mesh is not None else ("data", "model")
    sharder = Sharder(mesh if mesh is not None else {"data": 1, "model": 1},
                      rules or base_rules("pod" in names))
    model = build_model(cfg, device=device)
    dev = model.device
    specs = model.param_specs()
    param_axes = model.param_axes()
    param_shardings = unflatten({
        path: NamedSharding(sharder, sharder.spec(axes, specs[path][0]))
        for path, axes in flatten(param_axes).items()})
    opt_shardings = AdamWState(NamedSharding(sharder, ()), param_shardings,
                               param_shardings, param_shardings)
    dp = sharder.batch_axes()
    n_dp = sharder.ways(dp)
    layout = flatten(param_shardings)

    def batch_sharding(batch_tree):
        """The rows of every leaf (its leading dim, the global batch) over
        the batch axes; a batch they do not divide stays whole."""
        return _tree_map(
            lambda x: NamedSharding(sharder, sharder.spec(
                ("act_batch",) + (None,) * (len(x.shape) - 1), x.shape)),
            batch_tree)

    def cache_shardings_for(cache_tree):
        return _tree_map(
            lambda x, a: NamedSharding(sharder, sharder.spec(a, x.shape)),
            cache_tree, cache_axes(cache_tree))

    def to_device(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        # token ids as int64; float inputs (a VLM's image_embeds, an
        # encoder-decoder's frames) as they are
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(dev)
            out[k] = t if t.is_floating_point() else t.long()
        return out

    def mean_over_data(grads):
        """Sum each leaf whole over a data axis across those ranks (the
        FSDP gathers' backward summed the others)."""
        for path, g in grads.items():
            missing = tuple(a for a in dp
                            if a not in layout[path].mesh_axes())
            grads[path] = sharder.all_reduce(g, missing,
                                             downstream="per_rank")
        return grads

    def train_step(params, opt_state: AdamWState, batch):
        batch = to_device(batch)
        flat = flatten(params)
        leaves = list(flat.values())
        with use_sharder(sharder), torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            try:
                logits, aux = model.forward(params, batch)
                loss = lm_loss(logits, batch["labels"], aux)
                # this rank's rows: 1/n of the global mean's gradient
                grads = torch.autograd.grad(loss / n_dp if n_dp > 1 else loss,
                                            leaves, allow_unused=True)
            finally:
                for t in leaves:
                    t.requires_grad_(False)
        grads = mean_over_data({k: torch.zeros_like(t) if g is None else g
                                for (k, t), g in zip(flat.items(), grads)})
        loss = loss.detach()
        if n_dp > 1:
            loss = sharder.all_reduce(loss.clone(), dp,
                                      downstream="per_rank") / n_dp
        lr_scale = cosine_with_warmup(opt_state.step, warmup=warmup,
                                      total=total_steps)
        params, opt_state, metrics = apply_updates(
            params, unflatten(grads), opt_state, opt_cfg, lr_scale,
            shardings=param_shardings)
        metrics["loss"] = loss
        return params, opt_state, metrics

    def prefill_step(params, batch):
        with use_sharder(sharder), torch.no_grad():
            logits, _ = model.forward(params, to_device(batch))
        return logits

    def decode_step(params, tokens, cache, extra=None):
        tokens = torch.as_tensor(tokens).to(dev).long()
        with use_sharder(sharder), torch.no_grad():
            if cfg.family == "vlm":
                return model.decode_step(params, tokens, cache,
                                         image_embeds=torch.as_tensor(
                                             extra).to(dev))
            return model.decode_step(params, tokens, cache)

    def init_cache(batch_size: int, max_seq: int):
        """The cache for a global ``batch_size``: this rank's shard of it
        (its rows, its kv heads) under a mesh."""
        cache = model.init_cache(batch_size, max_seq)
        if mesh is None:
            return cache
        return _tree_map(lambda t, sh: sh.shard(t), cache,
                         cache_shardings_for(cache))

    def init_params(seed: int = 0):
        """The whole tree from ``seed`` (the same on every rank), cut to this
        rank's shards (on ``meta``: the shards' shapes, nothing drawn)."""
        if dev.type == "meta":
            return unflatten({
                path: torch.empty(sharder.local_shape(
                    shape, layout[path].spec), dtype=torch_dtype(dtype),
                    device=dev)
                for path, (shape, dtype, _) in specs.items()})
        with torch.no_grad():
            params = model.init(seed)
            if mesh is None:
                return params
            return shard_params(params, sharder, model=model)

    return Artifacts(cfg=cfg, mesh=mesh, sharder=sharder, model=model,
                     param_axes=param_axes, param_shardings=param_shardings,
                     opt_shardings=opt_shardings, train_step=train_step,
                     prefill_step=prefill_step, decode_step=decode_step,
                     batch_sharding=batch_sharding,
                     cache_shardings_for=cache_shardings_for,
                     init_params=init_params, init_opt=init_state,
                     init_cache=init_cache)
