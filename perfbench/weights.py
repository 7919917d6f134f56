"""The benchmark's weights and inputs, drawn from ``--seed`` on the device.

:func:`param_shapes` lays out the parameter tree the program takes (its
key paths, stacked layer axes and dtypes) from a configuration file's
widths alone; :func:`make_params` draws it with one ``torch.Generator`` on
the device, one call a leaf (a few dozen calls, each the whole stacked
leaf), in the dtype it is served in. The same tree is handed to the
program and to the reference.

Scales: matrices ``N(0, 1/fan_in)`` (fan-in = the contraction dim),
embeddings and Whisper's learned positions ``N(0, 1)`` and ``N(0, 0.02)``,
LayerNorm scales ``1 + N(0, 0.1)`` and biases ``N(0, 0.1)`` (f32), the
projections' biases ``N(0, 0.02)`` (bf16): random, so a bias or a scale
that is dropped or swapped shows in the outputs.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Shape = Tuple[int, ...]


def _block(out: dict, stack: str, n: int, scope: str, ln: str, mats) -> None:
    pre = f"{stack}/{scope}"
    out[f"{pre}/{ln}_scale"] = ((n, mats[0][1][0]), "float32", "ln_scale")
    out[f"{pre}/{ln}_bias"] = ((n, mats[0][1][0]), "float32", "ln_bias")
    for name, (k, nn) in mats:
        out[f"{pre}/{name}"] = ((n, k, nn), "bfloat16", "matrix")
        out[f"{pre}/{name}_b"] = ((n, nn), "bfloat16", "bias")


def param_shapes(cfg: dict) -> Dict[str, Tuple[Shape, str, str]]:
    """``{path: (shape, dtype, kind)}`` of the program's parameter tree for
    a configuration file ``cfg`` (its ``family``: ``dense`` or
    ``encdec``)."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    qd, kvd = cfg["n_heads"] * hd, cfg["kv_heads"] * hd
    ff, vocab = cfg["d_ff"], cfg["vocab"]
    attn = [("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
            ("wo", (qd, d))]
    ffn = [("wi", (d, ff)), ("wo", (ff, d))]
    out: Dict[str, Tuple[Shape, str, str]] = {
        "embedding": ((vocab, d), "bfloat16", "embedding"),
        "final_ln_scale": ((d,), "float32", "ln_scale"),
        "final_ln_bias": ((d,), "float32", "ln_bias"),
        "lm_head": ((d, vocab), "bfloat16", "matrix"),
    }
    if cfg["family"] == "dense":
        _block(out, "blocks", cfg["n_layers"], "attn", "ln1", attn)
        _block(out, "blocks", cfg["n_layers"], "ffn", "ln2", ffn)
    elif cfg["family"] == "encdec":
        out["enc_pos"] = ((cfg["enc_frames"], d), "bfloat16", "positions")
        e, n = cfg["enc_layers"], cfg["n_layers"]
        _block(out, "enc_blocks", e, "attn", "ln1", attn)
        _block(out, "enc_blocks", e, "ffn", "ln2", ffn)
        _block(out, "dec_blocks", n, "attn", "ln1", attn)
        _block(out, "dec_blocks", n, "xattn", "lnx", attn)
        _block(out, "dec_blocks", n, "ffn", "ln2", ffn)
    else:
        raise ValueError(f"unknown family {cfg['family']!r}")
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *scopes, name = path.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[name] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


_STD = {"embedding": 1.0, "positions": 0.02, "ln_bias": 0.1, "bias": 0.02,
        "ln_scale": 0.1}


@torch.no_grad()
def make_params(cfg: dict, seed: int, device) -> dict:
    """The parameter tree for ``cfg`` drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {}
    for path, (shape, dtype, kind) in param_shapes(cfg).items():
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=getattr(torch, dtype))
        std = (1.0 / shape[-2] ** 0.5) if kind == "matrix" else _STD[kind]
        t.mul_(std)
        if kind == "ln_scale":
            t.add_(1.0)
        flat[path] = t
    return unflatten(flat)


def generator(seed: int, device) -> torch.Generator:
    """A generator for the inputs, apart from the weights' stream."""
    return torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
