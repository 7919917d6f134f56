"""GPipe-style pipeline parallelism over a ``stage`` mesh dim, forward and
backward.

Ported from ``repro/parallel/pipeline.py``: the layer stack (L, ...) is
split onto S stages (L/S layers each); activations flow stage to stage
over M microbatches in the classic (M + S - 1)-step schedule (bubble
fraction (S-1)/(M+S-1)), and the last stage's outputs are broadcast to
every stage. The reference moves activations with a ring ``ppermute``
inside ``shard_map``; here stage ``r`` sends microbatch ``t - r`` to stage
``r + 1`` at step ``t`` (``isend``/``irecv``), and a stage idles through
the bubble steps instead of computing on zeros. Each layer runs as in the
sequential loop, so the output equals it bit for bit.

The gradient: the reference's ``ppermute`` transposes to the reverse
permutation under ``jax.grad``. Point-to-point calls are invisible to
autograd, and its engine would not order them across ranks, so the whole
schedule is one ``torch.autograd.Function`` whose backward runs the
reverse schedule explicitly: at reverse step ``t`` stage ``r`` takes
microbatch ``t - (S-1-r)``'s output gradient (the last stage its own, the
broadcast's replicated downstream; the others from stage ``r + 1``), back
through the graph its forward kept for that microbatch, and sends the
input gradient to stage ``r - 1``. Every rank holds the whole tree and
``x``, so the gradients are summed over the stages (each stage's rows,
zeros elsewhere) and stage 0's input gradient is broadcast. One stage has
no schedule to invert: plain autograd runs through its microbatch loop.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.module import flatten, layer_slice, unflatten
from repro_torch.parallel.sharding import Sharder


class _Stages:
    """One rank's place in the pipeline: its stage, its layer rows and the
    stage group's point-to-point and broadcast calls."""

    def __init__(self, mesh, stage_axis: str, lead: int, m: int):
        sharder = Sharder(mesh, {})
        self.s, self.m = sharder.size(stage_axis), m
        assert lead % self.s == 0, (lead, self.s)
        self.r = sharder.coords()[stage_axis]
        per = lead // self.s
        self.rows = range(self.r * per, (self.r + 1) * per)
        self.group = sharder.group(stage_axis) if self.s > 1 else None

    def peer(self, j: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, j)

    def exchange(self, ops) -> None:
        import torch.distributed as dist

        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def p2p(self, fn, t: torch.Tensor, j: int):
        import torch.distributed as dist

        return dist.P2POp(fn, t, self.peer(j), self.group)


def _forward(layer_fn, tree, x, st: _Stages, keep=None):
    """The forward schedule on this rank; the last stage's (M, B/M, ...)
    outputs. ``keep``: a dict that takes, for each microbatch this stage
    runs, its (input, output) pair with the graph between them (the caller
    enables grad)."""
    import torch.distributed as dist

    mine = [layer_slice(tree, i) for i in st.rows]
    s, m, r = st.s, st.m, st.r
    mbs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    outputs = torch.zeros_like(mbs)
    carry = None
    for t in range(m + s - 1):
        j = t - r                      # this stage's microbatch at step t
        ops = []
        if 0 <= j < m:
            h = mbs[j] if r == 0 else carry
            if keep is not None:
                h_in = h = h.detach().requires_grad_()
                for p in mine:
                    h = layer_fn(p, h)
                keep[j] = (h_in, h)
                h = h.detach()
            else:
                for p in mine:
                    h = layer_fn(p, h)
            if r == s - 1:
                outputs[j] = h
            else:                      # hand it to the next stage
                ops.append(st.p2p(dist.isend, h.contiguous(), r + 1))
        if r > 0 and 0 <= j + 1 < m:   # the previous stage's microbatch j+1
            carry = torch.empty_like(mbs[0])
            ops.append(st.p2p(dist.irecv, carry, r - 1))
        st.exchange(ops)
    return outputs


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, layer_fn, st, keys, x, *leaves):
        import torch.distributed as dist

        trainable = [p.detach().requires_grad_() for p in leaves]
        keep = {}
        with torch.enable_grad():  # the layer slices, too, join the graph
            outputs = _forward(layer_fn,
                               unflatten(dict(zip(keys, trainable))),
                               x.detach(), st, keep)
        dist.broadcast(outputs, src=st.peer(st.s - 1), group=st.group)
        ctx.st, ctx.keep, ctx.trainable = st, keep, trainable
        ctx.x_shape = x.shape
        return outputs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        st, keep, trainable = ctx.st, ctx.keep, ctx.trainable
        s, m, r = st.s, st.m, st.r
        gmbs = g.reshape(m, g.shape[0] // m, *g.shape[1:])
        dx = torch.zeros_like(gmbs)
        dparams = [torch.zeros_like(p) for p in trainable]
        carry = None
        for t in range(m + s - 1):
            j = t - (s - 1 - r)        # this stage's microbatch, reversed
            ops = []
            if 0 <= j < m:
                # the broadcast's downstream is replicated: the last
                # stage's own gradient, not a sum over the stages
                gj = gmbs[j] if r == s - 1 else carry
                h_in, h_out = keep.pop(j)
                got = torch.autograd.grad(h_out, [h_in] + trainable, gj,
                                          allow_unused=True)
                for acc, d in zip(dparams, got[1:]):
                    if d is not None:
                        acc.add_(d)
                if r == 0:
                    dx[j] = got[0]
                else:
                    ops.append(st.p2p(dist.isend, got[0].contiguous(), r - 1))
            if r < s - 1 and 0 <= j + 1 < m:
                carry = torch.empty_like(gmbs[0])
                ops.append(st.p2p(dist.irecv, carry, r + 1))
            st.exchange(ops)
        for d in dparams:              # each stage's rows: summed
            dist.all_reduce(d, group=st.group)
        dist.broadcast(dx, src=st.peer(0), group=st.group)
        return (None, None, None, dx.reshape(ctx.x_shape), *dparams)


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, *, n_microbatches: int,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run ``x`` through L stacked layers split across pipeline stages.

    ``layer_fn(params_slice, h) -> h`` applies ONE layer. ``stacked_params``
    is the whole tree on every rank (nested dicts; leaves have leading dim
    L with L % n_stages == 0; each stage applies its L/S rows); ``x`` (B,
    ...) is whole on every rank, B % n_microbatches == 0. ``mesh`` is a
    ``DeviceMesh`` with a ``stage_axis`` dim. Returns the (B, ...) output
    on every rank; under autograd, the gradients of the whole tree and of
    ``x`` come back whole on every rank (module doc).
    """
    flat = flatten(stacked_params)
    lead = next(iter(flat.values())).shape[0]
    assert x.shape[0] % n_microbatches == 0
    st = _Stages(mesh, stage_axis, lead, n_microbatches)
    if st.s == 1:                      # no schedule: autograd sees it all
        return _forward(layer_fn, stacked_params, x, st).reshape(x.shape)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in flat.values())):
        return _Pipeline.apply(layer_fn, st, list(flat), x, *flat.values())
    import torch.distributed as dist

    outputs = _forward(layer_fn, stacked_params, x, st)
    dist.broadcast(outputs, src=st.peer(st.s - 1), group=st.group)
    return outputs.reshape(x.shape)
