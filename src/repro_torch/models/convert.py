"""Carry a JAX package parameter tree across to the port.

``jax.random`` draws cannot be reproduced in torch, so parity tests make the
weights once with the reference and load them here. The input is the JAX
param pytree with numpy leaves (``jax.tree.map(np.asarray, params)``); the
key paths are identical in both packages, including the stacked layer axes
(``blocks``, ``enc_blocks``/``dec_blocks``, ``mlstm_blocks``/``slstm_blocks``,
``mamba_blocks``) and their f32 leaves (norms, the sLSTM's ``r_*``,
Mamba's ``a_log``/``d_skip``).

:func:`shard_params` then cuts a whole tree to one rank's shards, the
counterpart of the reference engine's ``jax.device_put(params,
shardings)``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.config import torch_dtype
from repro_torch.parallel.sharding import Sharder, shard_tensor

from .common import ArchConfig
from .module import Params, flatten, unflatten
from .registry import build_model


def _to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if t.dtype != dtype:
        raise ValueError(f"dtype {t.dtype} where the port expects {dtype}")
    return t.to(device)


def params_from_jax(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Params:
    """The port's parameters for ``cfg`` from the JAX package's tree.

    Raises if the paths, shapes or dtypes differ from what the port's model
    for ``cfg.family`` (``DecoderLM``, ``EncDecLM``, ``XLSTMModel``,
    ``ZambaModel``, ``CNNModel``) declares in its ``param_specs``.
    """
    model = build_model(cfg, device=device)
    specs = model.param_specs()
    flat = flatten(np_tree)
    if set(flat) != set(specs):
        raise ValueError(
            f"param paths differ: only in JAX {sorted(set(flat) - set(specs))}, "
            f"only in the port {sorted(set(specs) - set(flat))}")
    loaded = {}
    for path, (shape, dtype, _) in specs.items():
        arr = flat[path]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, port "
                             f"expects {tuple(shape)}")
        loaded[path] = _to_tensor(arr, torch_dtype(dtype), model.device)
    return unflatten(loaded)


def shard_params(params: Params, sharder: Sharder,
                 coords: Optional[Mapping[str, int]] = None, *,
                 model) -> Params:
    """This rank's shards of a whole parameter tree (from
    :func:`params_from_jax` or the port's own ``init``): each leaf cut by
    ``sharder.spec`` of its logical axes (the model's ``param_axes``) and
    global shape, at the mesh ``coords`` (default: this rank's). Leaves
    nothing splits are kept, not copied."""
    coords = sharder.coords() if coords is None else coords
    axes = flatten(model.param_axes())
    flat = flatten(params)
    if set(flat) != set(axes):
        raise ValueError(f"param paths differ from {type(model).__name__}'s: "
                         f"{sorted(set(flat) ^ set(axes))}")
    return unflatten({
        path: shard_tensor(sharder, t, sharder.spec(axes[path], t.shape),
                           coords)
        for path, t in flat.items()})
