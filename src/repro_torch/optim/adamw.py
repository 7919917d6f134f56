"""AdamW with f32 master weights and global-norm clipping.

The JAX package's optimizer (``repro/optim/adamw.py``), written out
directly: ``torch.optim.AdamW`` clips, rounds and orders its arithmetic
elsewhere. The state is a tuple of parameter-shaped dicts (f32 master, m,
v) and a step counter. Unlike the reference, which returns new trees,
:func:`apply_updates` updates the state and the parameters in place: on one
card that saves a second copy of the ~13 GB of f32 state a 1.1e9-parameter
model carries.

Under a mesh every rank updates its own shards; ``shardings`` (a tree of
``parallel.sharding.NamedSharding`` like the gradients') makes the clip's
norm the global one: each leaf's squared sum is summed over the mesh axes
that leaf is split on, and a leaf whole on an axis is counted once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.module import flatten, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    master: Any              # f32 copy of params
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params) -> AdamWState:
    """Master copy and zero moments in f32, step 0, on the params' device."""
    flat = flatten(params)
    device = next(iter(flat.values())).device if flat else None

    def zeros():
        return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for k, p in flat.items()})

    master = unflatten({k: p.detach().to(torch.float32, copy=True)
                        for k, p in flat.items()})
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      master, zeros(), zeros())


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The norm of every leaf of ``tree`` together; with ``shardings``, of
    the whole tensors the leaves are shards of (module doc)."""
    if shardings is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in flatten(tree).values()))
    layout = flatten(shardings)

    def sq(path, x):
        part = torch.sum(torch.square(x.to(torch.float32)))
        sh = layout[path]
        return sh.sharder.all_reduce(part, sh.mesh_axes(),
                                     downstream="per_rank")

    return torch.sqrt(sum(sq(path, x) for path, x in flatten(tree).items()))


def state_axes(param_axes_tree) -> AdamWState:
    """Logical axes for the optimizer state (same as params, FSDP-sharded)."""
    return AdamWState((), param_axes_tree, param_axes_tree, param_axes_tree)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig,
                  lr_scale=1.0, *, shardings=None
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (params, state, metrics); the params and the
    state's master, m and v are updated in place. ``shardings``: the
    parameters' layout under a mesh (the global norm; module doc)."""
    step = state.step + 1
    gnorm = global_norm(grads, shardings)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    others = [flatten(t) for t in (grads, state.master, state.m, state.v)]
    for path, p in flatten(params).items():
        g, mast, m, v = (t[path] for t in others)
        g = g.to(torch.float32) * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        mast.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * mast))
        p.copy_(mast)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.master, state.m, state.v), metrics
