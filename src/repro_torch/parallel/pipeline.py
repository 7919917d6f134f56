"""GPipe-style pipeline parallelism over a ``stage`` mesh dim (forward).

Ported from ``repro/parallel/pipeline.py``: the layer stack (L, ...) is
split onto S stages (L/S layers each); activations flow stage to stage
over M microbatches in the classic (M + S - 1)-step schedule (bubble
fraction (S-1)/(M+S-1)), and the last stage's outputs are broadcast to
every stage. The reference moves activations with a ring ``ppermute``
inside ``shard_map``; here stage ``r`` sends microbatch ``t - r`` to stage
``r + 1`` at step ``t`` (``isend``/``irecv``), and a stage idles through
the bubble steps instead of computing on zeros. Each layer runs as in the
sequential loop, so the output equals it bit for bit.

Forward only: the gradient through the pipeline belongs to the sharded
train step, which is not ported yet (ROADMAP.md, A item 8b).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.module import flatten, layer_slice
from repro_torch.parallel.sharding import Sharder


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, *, n_microbatches: int,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run ``x`` through L stacked layers split across pipeline stages.

    ``layer_fn(params_slice, h) -> h`` applies ONE layer. ``stacked_params``
    is the whole tree on every rank (nested dicts; leaves have leading dim
    L with L % n_stages == 0; each stage applies its L/S rows); ``x`` (B,
    ...) is whole on every rank, B % n_microbatches == 0. ``mesh`` is a
    ``DeviceMesh`` with a ``stage_axis`` dim. Returns the (B, ...) output
    on every rank.
    """
    import torch.distributed as dist

    sharder = Sharder(mesh, {})
    s, m = sharder.size(stage_axis), n_microbatches
    lead = next(iter(flatten(stacked_params).values())).shape[0]
    assert lead % s == 0, (lead, s)
    assert x.shape[0] % m == 0
    r = sharder.coords()[stage_axis]
    per = lead // s
    mine = [layer_slice(stacked_params, i)
            for i in range(r * per, (r + 1) * per)]
    group = sharder.group(stage_axis) if s > 1 else None

    def peer(j):
        return dist.get_global_rank(group, j)

    mbs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    outputs = torch.zeros_like(mbs)
    carry = None
    for t in range(m + s - 1):
        j = t - r                      # this stage's microbatch at step t
        ops = []
        if 0 <= j < m:
            h = mbs[j] if r == 0 else carry
            for p in mine:
                h = layer_fn(p, h)
            if r == s - 1:
                outputs[j] = h
            else:                      # hand it to the next stage
                ops.append(dist.P2POp(dist.isend, h.contiguous(),
                                      peer(r + 1), group))
        if r > 0 and 0 <= j + 1 < m:   # the previous stage's microbatch j+1
            carry = torch.empty_like(mbs[0])
            ops.append(dist.P2POp(dist.irecv, carry, peer(r - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if s > 1:
        dist.broadcast(outputs, src=peer(s - 1), group=group)
    return outputs.reshape(x.shape)
