"""The train and prefill steps on one device.

``build_artifacts`` assembles, for one architecture, the model and its step
functions: the port of ``repro/launch/steps.py`` without the mesh, the
sharder and the abstract trees (one card, eager PyTorch; there is nothing
to lay out or compile).

* ``train_step(params, opt, batch) -> (params, opt, metrics)``: forward,
  ``lm_loss``, the backward pass, ``apply_updates`` with the cosine
  schedule. As in the reference, the schedule reads the optimizer's step
  *before* it is incremented, so the first step has ``lr_scale = 0`` and
  leaves the parameters as they were. The parameters and the optimizer
  state are updated in place (see ``optim/adamw.py``).
* ``prefill_step(params, batch) -> logits``: the full-sequence forward
  under ``torch.no_grad()``.
* ``decode_step`` needs the slot caches, which are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.module import flatten, unflatten
from repro_torch.models.registry import build_model, lm_loss
from repro_torch.optim import (AdamWConfig, AdamWState, apply_updates,
                               cosine_with_warmup, init_state)


@dataclasses.dataclass
class Artifacts:
    cfg: ArchConfig
    model: Any
    train_step: Callable      # (params, opt, batch) -> (params, opt, metrics)
    prefill_step: Callable    # (params, batch) -> logits
    decode_step: Callable     # not ported: raises
    init_params: Callable[[int], Any]
    init_opt: Callable[[Any], AdamWState]


def build_artifacts(cfg: ArchConfig, *, device="cuda",
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    total_steps: int = 100_000,
                    warmup: int = 1000) -> Artifacts:
    """The steps for ``cfg`` on ``device`` (default: the card)."""
    model = build_model(cfg, device=device)
    dev = model.device

    def to_device(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(dev).long() for k, v in batch.items()}

    def train_step(params, opt_state: AdamWState, batch):
        batch = to_device(batch)
        flat = flatten(params)
        leaves = list(flat.values())
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            try:
                logits, aux = model.forward(params, batch)
                loss = lm_loss(logits, batch["labels"], aux)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            finally:
                for t in leaves:
                    t.requires_grad_(False)
        grads = unflatten({k: torch.zeros_like(t) if g is None else g
                           for (k, t), g in zip(flat.items(), grads)})
        lr_scale = cosine_with_warmup(opt_state.step, warmup=warmup,
                                      total=total_steps)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg, lr_scale)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = model.forward(params, to_device(batch))
        return logits

    def decode_step(params, tokens, cache):
        raise NotImplementedError(
            "decode_step needs the slot caches (init_cache, _cached_forward, "
            "prefill), which are not ported yet (ROADMAP §A); serve through "
            "repro_torch.serve, whose paged_step is ported")

    def init_params(seed: int = 0):
        with torch.no_grad():
            return model.init(seed)

    return Artifacts(cfg=cfg, model=model, train_step=train_step,
                     prefill_step=prefill_step, decode_step=decode_step,
                     init_params=init_params, init_opt=init_state)
