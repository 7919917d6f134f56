"""The train, prefill and decode steps on one device.

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
* ``decode_step(params, tokens, cache, extra=None) -> (logits, cache)``:
  one token through ``model.decode_step`` under ``torch.no_grad()`` (a
  VLM's ``extra`` is its ``image_embeds``), on a cache from
  ``init_cache(batch_size, max_seq)`` (allocated on the artifacts'
  device; the reference's ``make_cache_shapes`` gives the same tree
  abstractly): a slot cache, an encoder-decoder's with ``enc`` (the caller
  fills it with ``model.encode``), or the recurrent states of xLSTM and
  Zamba. The cache is written in place.

Every family trains and prefills alike: an audio batch carries
``frames`` beside ``tokens`` and ``labels``.
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
    decode_step: Callable     # (params, tokens, cache[, extra]) -> (logits, cache)
    init_params: Callable[[int], Any]
    init_opt: Callable[[Any], AdamWState]
    init_cache: Callable[[int, int], Dict[str, torch.Tensor]]


def build_artifacts(cfg: ArchConfig, *, device="cuda",
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    total_steps: int = 100_000,
                    warmup: int = 1000) -> Artifacts:
    """The steps for ``cfg`` on ``device`` (default: the card)."""
    model = build_model(cfg, device=device)
    dev = model.device

    def to_device(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        # token ids as int64; float inputs (a VLM's image_embeds, an
        # encoder-decoder's frames) as they are
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(dev)
            out[k] = t if t.is_floating_point() else t.long()
        return out

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

    def decode_step(params, tokens, cache, extra=None):
        tokens = torch.as_tensor(tokens).to(dev).long()
        with torch.no_grad():
            if cfg.family == "vlm":
                return model.decode_step(params, tokens, cache,
                                         image_embeds=torch.as_tensor(
                                             extra).to(dev))
            return model.decode_step(params, tokens, cache)

    def init_cache(batch_size: int, max_seq: int):
        return model.init_cache(batch_size, max_seq)

    def init_params(seed: int = 0):
        with torch.no_grad():
            return model.init(seed)

    return Artifacts(cfg=cfg, model=model, train_step=train_step,
                     prefill_step=prefill_step, decode_step=decode_step,
                     init_params=init_params, init_opt=init_state,
                     init_cache=init_cache)
