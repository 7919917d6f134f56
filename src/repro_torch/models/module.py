"""Parameter trees, their initializers, and the apply context.

A model's parameters are a nested dict of tensors with the JAX package's key
paths (``blocks/attn/wq`` ...); a layer stack is *stacked* (leading layer
axis), as in the reference, so one parameter tree converts 1:1 between the
packages. Model functions read parameters through a :class:`Ctx`, whose
``scope`` also pushes the op-site path, so site paths mirror parameter paths.

Initializers draw from an explicit ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from repro_torch.core.config import torch_dtype
from repro_torch.policy.sites import site_scope

Params = Dict[str, Any]
Init = Callable[[torch.Generator, Sequence[int], Any, torch.device], torch.Tensor]


# ---------------------------------------------------------------------------
# Initializers (match common LM practice and the JAX package's choices)
# ---------------------------------------------------------------------------

def _normal(gen, shape, std, dtype, device):
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    # scaled in place: a stacked (layers, d, d_ff) draw is the largest
    # transient of an init (StarCoder2-15B's f32 wi takes 24 GB)
    return x.mul_(std).to(torch_dtype(dtype))


def normal_init(stddev: float = 0.02) -> Init:
    def init(gen, shape, dtype, device):
        return _normal(gen, shape, stddev, dtype, device)
    return init


def lecun_init() -> Init:
    def init(gen, shape, dtype, device):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return _normal(gen, shape, 1.0 / np.sqrt(fan_in), dtype, device)
    return init


def he_init() -> Init:
    """Kaiming/He init (gain 2 for ReLU), for deep plain-ReLU stacks like
    VGG-16 without normalization layers. For conv kernels (kh, kw, cin,
    cout) fan_in = kh*kw*cin."""
    def init(gen, shape, dtype, device):
        fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else shape[-1]
        return _normal(gen, shape, np.sqrt(2.0 / fan_in), dtype, device)
    return init


def zeros_init() -> Init:
    def init(gen, shape, dtype, device):
        return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=device)
    return init


def ones_init() -> Init:
    def init(gen, shape, dtype, device):
        return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=device)
    return init


class ParamSpec(tuple):
    """One parameter's ``(shape, dtype, init)``, with its logical sharding
    axes (the reference's ``ctx.param(..., axes=...)``) as ``.axes``: one
    name or None per dim, such as ``("layers", "embed", "heads")``."""

    def __new__(cls, shape, dtype, init, axes):
        spec = super().__new__(cls, (tuple(shape), dtype, init))
        if len(axes) != len(spec[0]):
            raise ValueError(f"axes {axes} for a shape {spec[0]}")
        spec.axes = tuple(axes)
        return spec


def axes_tree(specs: Dict[str, ParamSpec]) -> Params:
    """Nested dict of each parameter's logical axes (the reference's
    ``axes_tree(*model.init(key, abstract=True))``)."""
    return unflatten({path: s.axes for path, s in specs.items()})


def init_params(specs: Dict[str, tuple], gen: torch.Generator,
                device: torch.device) -> Params:
    """Build a nested param dict from ``{"a/b/c": (shape, dtype, init)}``
    (drawn in the specs' order)."""
    return unflatten({path: init(gen, shape, dtype, device)
                      for path, (shape, dtype, init) in specs.items()})


def unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    """``{"a/b/c": tensor}`` -> nested dict."""
    params: Params = {}
    for path, leaf in flat.items():
        *scopes, name = path.split("/")
        t = params
        for s in scopes:
            t = t.setdefault(s, {})
        t[name] = leaf
    return params


def flatten(params: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict -> ``{"a/b/c": tensor}``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def layer_slice(tree, i):
    """Row ``i`` (an int or a slice) of every leaf of a stacked tree (dicts
    and tuples of tensors, as the recurrent models' caches are)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(layer_slice(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# Apply context
# ---------------------------------------------------------------------------

class Ctx:
    """Parameter lookup context over an existing param tree.

    ``scope`` enters a parameter sub-tree and pushes the same name onto the
    op-site path stack.
    """

    def __init__(self, params: Params):
        self.params = params
        self._path: list = []

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator["Ctx"]:
        self._path.append(name)
        try:
            with site_scope(name):
                yield self
        finally:
            self._path.pop()

    def param(self, name: str) -> torch.Tensor:
        t = self.params
        for p in self._path:
            if p not in t:
                raise KeyError(f"missing param scope {'/'.join(self._path)}")
            t = t[p]
        if name not in t:
            raise KeyError(f"missing param {'/'.join(self._path + [name])}")
        return t[name]
