"""Architecture configs: the JAX package's ids and aliases.

``get_config`` takes the same ``--arch`` ids as ``repro.configs``; every
one of them is ported, and ``PORTED_IDS`` lists them all.
"""
from __future__ import annotations

import importlib

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
