"""The paper's evaluation CNNs: LeNet-5, VGG-16 (variation D, 2 FC), VGG-8.

All convolutions and FCs route through the DAISM GEMM (im2col: exactly how
the accelerator consumes them, kernels flattened into SRAM rows, paper Fig
4), so the Table-2 accuracy experiments run the numerics the multiplier
tests validate bit for bit. Ported from ``repro/models/cnn.py``: the same
parameter keys and shapes (a flat tree ``c1``, ``c1_b``, ..., ``f1``,
``out``), the same site paths (``cnn/c0``, an ``OpKind.CONV``; ``cnn/out``,
an ``OpKind.LM_HEAD``) and NHWC images.

Each net is one function over a parameter context. :class:`CNNModel` runs
it on real parameters (``forward``) or on the ``meta`` device, where it
only records each parameter's shape (``param_specs``), as the reference
builds its tree by running the net in its init mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.config import torch_dtype
from repro_torch.policy import OpKind, policy_conv2d, policy_dot, site_scope
from repro_torch.runtime.device import resolve_device

from .common import EXACT, ArchConfig
from .module import (ParamSpec, axes_tree, he_init, init_params, lecun_init,
                     zeros_init)

Params = Dict[str, Any]


class _Apply:
    """Parameters of a forward, read by name."""

    record = True

    def __init__(self, params: Params):
        self.params = params

    def param(self, name, shape, dtype, init):
        return self.params[name]


class _Specs:
    """Records ``{name: (shape, dtype, init)}`` and hands out ``meta``
    tensors of that shape, so a net run under it computes no values."""

    record = False

    def __init__(self):
        self.specs: Dict[str, tuple] = {}

    def param(self, name, shape, dtype, init):
        # the reference declares no sharding axes for the CNNs
        self.specs[name] = ParamSpec(shape, dtype, init, (None,) * len(shape))
        return torch.empty(shape, dtype=torch_dtype(dtype), device="meta")


def _conv(ctx, name: str, x, cout: int, cfg: ArchConfig, *, k: int = 3,
          init=None):
    cin = x.shape[-1]
    w = ctx.param(name, (k, k, cin, cout), cfg.param_dtype,
                  init or lecun_init())
    b = ctx.param(name + "_b", (cout,), cfg.param_dtype, zeros_init())
    y = policy_conv2d(cfg.approx_policy, x, w, name=name, padding="SAME",
                      record=ctx.record)
    return y + b.to(x.dtype)


def _fc(ctx, name: str, x, dout: int, cfg: ArchConfig,
        kind: OpKind = OpKind.DENSE):
    din = x.shape[-1]
    w = ctx.param(name, (din, dout), cfg.param_dtype, lecun_init())
    b = ctx.param(name + "_b", (dout,), cfg.param_dtype, zeros_init())
    y = policy_dot(cfg.approx_policy, x, w, name=name, kind=kind,
                   record=ctx.record)
    return y + b.to(x.dtype)


def _pool(x):
    """2x2 max pool, stride 2, VALID, on NHWC (``lax.reduce_window`` with
    -inf in the reference)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def lenet5(ctx, images: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """images: (B, 28, 28, 1) -> logits (B, 10)."""
    x = images.to(torch_dtype(cfg.compute_dtype))
    x = torch.tanh(_conv(ctx, "c1", x, 6, cfg, k=5))
    x = _pool(x)
    x = torch.tanh(_conv(ctx, "c2", x, 16, cfg, k=5))
    x = _pool(x)
    x = x.reshape(x.shape[0], -1)
    x = torch.tanh(_fc(ctx, "f1", x, 120, cfg))
    x = torch.tanh(_fc(ctx, "f2", x, 84, cfg))
    return _fc(ctx, "out", x, cfg.vocab, cfg,
               kind=OpKind.LM_HEAD).to(torch.float32)


_VGG16 = (64, 64, "P", 128, 128, "P", 256, 256, 256, "P",
          512, 512, 512, "P", 512, 512, 512, "P")
_VGG8 = (64, "P", 128, "P", 256, "P", 512, "P", 512, "P")


def _vgg(ctx, images, cfg: ArchConfig, plan: Sequence, fc_dim: int):
    x = images.to(torch_dtype(cfg.compute_dtype))
    i = 0
    for item in plan:
        if item == "P":
            x = _pool(x)
        else:
            # He init: a 16-layer plain-ReLU stack needs gain-2 init to
            # train without normalization (as the original VGG recipe did)
            x = F.relu(_conv(ctx, f"c{i}", x, item, cfg, init=he_init()))
            i += 1
    x = x.reshape(x.shape[0], -1)
    x = F.relu(_fc(ctx, "f1", x, fc_dim, cfg))
    return _fc(ctx, "out", x, cfg.vocab, cfg,
               kind=OpKind.LM_HEAD).to(torch.float32)


def vgg16(ctx, images, cfg: ArchConfig):
    """VGG-16 variation D with 2 FC layers (paper §5.1.1), CIFAR10 32x32."""
    return _vgg(ctx, images, cfg, _VGG16, 512)


def vgg8(ctx, images, cfg: ArchConfig):
    return _vgg(ctx, images, cfg, _VGG8, 512)


class CNNModel:
    """The LM model API for the CNNs (no decode path): ``param_specs``,
    ``init(seed)`` and ``forward(params, {"images": ...})``.

    ``device`` is where :meth:`init` allocates; it defaults to the card.
    """

    _FNS = {"lenet5": lenet5, "vgg16": vgg16, "vgg8": vgg8}

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.fn = self._FNS[cfg.name.split("-")[0]]
        self.device = resolve_device(device)

    def default_image_shape(self):
        """One image, NHWC: MNIST's for LeNet-5, CIFAR-10's for the VGGs."""
        return (1, 28, 28, 1) if "lenet" in self.cfg.name else (1, 32, 32, 3)

    def param_specs(self, image_shape=None) -> Dict[str, tuple]:
        """``{name: (shape, dtype, init)}`` of every parameter, with the JAX
        package's keys and shapes, found by running the net on the ``meta``
        device (exact numerics, nothing recorded)."""
        shape = image_shape or self.default_image_shape()
        specs = _Specs()
        cfg = dataclasses.replace(self.cfg, policy=None, daism=EXACT)
        with site_scope("cnn"):
            self.fn(specs, torch.empty(shape, device="meta"), cfg)
        return specs.specs

    def init(self, seed: int = 0, image_shape=None) -> Params:
        """Random parameters on ``self.device`` from a ``torch.Generator``
        seeded with ``seed`` (lecun, He for the VGG convs, zero biases)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_specs(image_shape), gen, self.device)

    def param_axes(self, image_shape=None):
        """Each parameter's logical axes (all None), keyed like the
        params."""
        return axes_tree(self.param_specs(image_shape))

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]):
        """images (B, H, W, C) -> (logits (B, classes) f32, aux 0.0)."""
        images = batch["images"]
        with site_scope("cnn"):
            out = self.fn(_Apply(params), images, self.cfg)
        return out, torch.zeros((), dtype=torch.float32, device=images.device)
