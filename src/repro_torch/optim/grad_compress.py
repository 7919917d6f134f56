"""Gradient compression for the data-parallel all-reduce.

Ported from ``repro/optim/grad_compress.py``; the reference psums inside a
``shard_map`` over named mesh axes, the port all-reduces over the process
groups of the named dims of a ``DeviceMesh``. Two compressed modes:

* ``bf16``: cast gradients to bf16 before the sum: half the all-reduce
  traffic of f32;
* ``int8``: two phases: (1) the per-leaf scale all-reduced with MAX across
  replicas, (2) each leaf quantized with that global scale and the int8
  payload summed widened to int32 (no overflow).

``none`` sums in f32. Every mode returns the mean over the ranks.
"""
from __future__ import annotations

import math
from typing import Any

import torch


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def compressed_psum(grads: Any, axis_names, mode: str = "int8", *,
                    mesh=None) -> Any:
    """Mean-reduce a gradient tree (dicts, lists and tuples of tensors)
    across the mesh dims ``axis_names`` with compression. ``mesh`` is a
    ``DeviceMesh`` (default: the ambient sharder's); the caller's tensors
    are not modified."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import Sharder, current_sharder

    if mode not in ("none", "bf16", "int8"):
        raise ValueError(f"compression mode {mode!r} (none | bf16 | int8)")
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if mesh is None:
        if current_sharder() is None:
            raise ValueError("compressed_psum needs a mesh: pass mesh= or "
                             "run under use_sharder")
        mesh = current_sharder().mesh
    sharder = Sharder(mesh, {})
    n = math.prod(sharder.size(a) for a in axis_names)

    def psum_all(x, op=dist.ReduceOp.SUM):
        # each rank's gradient is its own: a sum over the data ranks
        return sharder.all_reduce(x, tuple(axis_names), op=op,
                                  downstream="per_rank")

    def one(g):
        if mode == "none":
            return psum_all(g.to(torch.float32).clone()) / n
        if mode == "bf16":
            return (psum_all(g.to(torch.bfloat16).clone()).to(torch.float32)
                    / n).to(g.dtype)
        # int8: the global scale first (a scalar all-reduce), then the payload
        s = torch.amax(torch.abs(g.to(torch.float32))) / 127.0 + 1e-12
        s = psum_all(s.reshape(1), op=dist.ReduceOp.MAX)[0]
        q = quantize_int8(g, s).to(torch.int32)
        total = psum_all(q)
        return (total.to(torch.float32) * s / n).to(g.dtype)

    return _tree_map(one, grads)
