"""Architecture configs: the JAX package's ids and aliases.

``get_config`` takes the same ``--arch`` ids as ``repro.configs``; every
one of them is ported, and ``PORTED_IDS`` lists them all. ``SHAPES``,
``cell_enabled`` and ``input_specs`` are the dry-run's cells
(``launch/dryrun.py``): ``input_specs`` gives ``meta`` tensors where the
reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from repro_torch.core.config import torch_dtype

from repro_torch.models.common import ArchConfig

ARCH_IDS = (
    "tinyllama_1_1b",
    "gemma_2b",
    "starcoder2_15b",
    "nemotron_4_340b",
    "dbrx_132b",
    "qwen3_moe_235b",
    "llama_3_2_vision_11b",
    "xlstm_1_3b",
    "whisper_large_v3",
    "zamba2_1_2b",
)

PAPER_IDS = ("lenet5", "vgg16", "vgg8")

PORTED_IDS = ARCH_IDS + PAPER_IDS

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS + PAPER_IDS}


def get_config(arch: str) -> ArchConfig:
    arch = _ALIAS.get(arch, arch)
    if arch not in ARCH_IDS + PAPER_IDS:
        raise ValueError(f"unknown arch {arch!r}; expected one of "
                         f"{sorted(ARCH_IDS + PAPER_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


# ---------------------------------------------------------------------------
# Assigned input shapes (LM shapes are seq_len x global_batch)
# ---------------------------------------------------------------------------

SHAPES: Dict[str, Tuple[int, int, str]] = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# Mandated skips (DESIGN.md §4): long_500k only for SSM/hybrid.
_LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_enabled(cfg: ArchConfig, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.family in _LONG_OK_FAMILIES
    return True


def input_specs(cfg: ArchConfig, shape_name: str):
    """``meta`` stand-ins for every model input of a dry-run cell, at the
    global shapes. Returns (batch_dict, kind); a decode cell's cache comes
    from the artifacts' ``init_cache``."""
    return shape_specs(cfg, *SHAPES[shape_name])


def shape_specs(cfg: ArchConfig, seq: int, batch: int, kind: str):
    """:func:`input_specs` of any (seq, batch, kind)."""

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    specs = {}
    if kind in ("train", "prefill"):
        specs["tokens"] = meta((batch, seq), i32)
        if kind == "train":
            specs["labels"] = meta((batch, seq), i32)
    else:  # decode: one new token against a cache of length seq
        specs["tokens"] = meta((batch, 1), i32)
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.family == "vlm":
        specs["image_embeds"] = meta((batch, cfg.n_image_tokens,
                                      cfg.d_model), dt)
    if cfg.family == "audio":
        specs["frames"] = meta((batch, cfg.enc_frames, cfg.d_model), dt)
    return specs, kind
