"""Where the benchmark meets the program (``repro_torch``): the program's
configuration for a cell, built from the registry id and the widths of the
cell's configuration file. The drivers call the program's own entry points
(``launch/steps.py``, ``serve/engine.py``); nothing else of it is used.
"""
from __future__ import annotations

import dataclasses


def widths(config: dict) -> dict:
    """The sizes the harness and the reference compute with, from a
    configuration file's published keys (as run, after ``reduced``)."""
    if config["family"] == "dense":
        d, h = config["hidden_size"], config["num_attention_heads"]
        return {"family": "dense", "d_model": d, "n_heads": h,
                "kv_heads": config["num_key_value_heads"],
                "head_dim": d // h, "d_ff": config["intermediate_size"],
                "vocab": config["vocab_size"],
                "n_layers": config["num_hidden_layers"],
                "rope_theta": float(config["rope_theta"])}
    if config["family"] == "encdec":
        d, h = config["d_model"], config["decoder_attention_heads"]
        return {"family": "encdec", "d_model": d, "n_heads": h,
                "kv_heads": h, "head_dim": d // h,
                "d_ff": config["decoder_ffn_dim"],
                "vocab": config["vocab_size"],
                "n_layers": config["decoder_layers"],
                "enc_layers": config["encoder_layers"],
                "enc_frames": config["max_source_positions"],
                "max_target": config["max_target_positions"]}
    raise ValueError(f"unknown family {config['family']!r}")


def arch(config: dict, policy: str, backward: str = ""):
    """The program's ``ArchConfig``: the registry entry ``program_id``,
    with the file's widths and depths, under ``policy`` (a spec string;
    ``backward``, if given, is every approximate rule's backward mode:
    the spec syntax has no field for it)."""
    from repro_torch.configs import get_config
    from repro_torch.policy import parse_policy

    w = widths(config)
    base = get_config(config["program_id"])
    sizes = {k: w[k] for k in ("d_model", "n_heads", "kv_heads", "head_dim",
                               "d_ff", "vocab", "n_layers")}
    if w["family"] == "encdec":
        sizes.update(enc_layers=w["enc_layers"], enc_frames=w["enc_frames"])
    pol = parse_policy(policy)
    if backward:
        pol = dataclasses.replace(pol, rules=tuple(
            dataclasses.replace(r, config=r.config.replace(backward=backward))
            if not r.config.exact else r for r in pol.rules))
    return dataclasses.replace(base, **sizes).with_policy(pol)


def sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)

