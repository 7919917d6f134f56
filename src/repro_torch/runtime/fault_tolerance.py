"""Fault-tolerant training driver: checkpoint/restart, straggler watchdog,
simulated pre-emption.

The port of ``repro/runtime/fault_tolerance.py``, on one device or on
every rank of a mesh, with the reference's restart semantics:

  * every step runs inside the resume loop: after a crash the process (or
    its replacement) calls :func:`run` again and resumes from the newest
    complete checkpoint (the sentinel protocol of ``checkpoint.py``); tests
    raise :class:`SimulatedPreemption` from ``fault_hook``;
  * a step-time EWMA watchdog (``runtime/watchdog.py``) counts steps slower
    than ``straggler_factor`` x the running mean.

The data iterator is not checkpointed, as in the reference: a resumed run
draws from the generator it is given, from its start. Under a mesh
(``param_shardings`` / ``opt_shardings``, from ``build_artifacts``) the
checkpoint holds the global arrays and every rank restores its shards, so
a run resumes onto another mesh (elastic restore); every rank takes the
same checkpoint decisions from the step count (the watchdog only logs:
no decision reads a clock), and the logged loss is the global batch's.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.runtime.watchdog import StepWatchdog

log = logging.getLogger("repro_torch.runtime")


class SimulatedPreemption(RuntimeError):
    """Raised by tests to model a host loss at an arbitrary step."""


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 25
    keep: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    log_every: int = 10


@dataclasses.dataclass
class LoopState:
    step: int = 0
    ewma_step_time: float = 0.0
    stragglers: int = 0
    measured_steps: int = 0  # steps contributing to the EWMA (skips warmup)


def _wait(t) -> None:
    """Block until the card has computed ``t`` (the step's end)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def run(loop_cfg: TrainLoopConfig,
        train_step: Callable,
        params: Any, opt_state: Any,
        batches: Iterator[Dict],
        put_batch: Callable[[Dict], Dict],
        *,
        fault_hook: Optional[Callable[[int], None]] = None,
        metrics_hook: Optional[Callable[[int, Dict], None]] = None,
        param_shardings: Any = None,
        opt_shardings: Any = None):
    """Resumable training loop. Returns (params, opt_state, LoopState).

    On entry, if a checkpoint exists in ``ckpt_dir`` the passed-in
    params/opt_state are REPLACED by the restored ones (fresh tensors on
    the same devices: restart semantics). ``fault_hook(step)`` is called
    before each step (tests raise SimulatedPreemption from it);
    ``metrics_hook(step, {name: float})`` every ``log_every`` steps.
    ``param_shardings`` / ``opt_shardings``: the layout of a mesh run
    (module doc).
    """
    shardings = ({"params": param_shardings, "opt": opt_shardings}
                 if param_shardings is not None else None)
    state = LoopState()
    watchdog = StepWatchdog(factor=loop_cfg.straggler_factor,
                            alpha=loop_cfg.ewma_alpha)
    last = ckpt.latest_step(loop_cfg.ckpt_dir)
    if last is not None:  # restart semantics: joint {"params","opt"} layout
        log.warning("resuming from checkpoint step %d", last)
        tree = ckpt.restore(loop_cfg.ckpt_dir, last,
                            {"params": params, "opt": opt_state}, shardings)
        params, opt_state = tree["params"], tree["opt"]
        state.step = last

    while state.step < loop_cfg.total_steps:
        if fault_hook is not None:
            fault_hook(state.step)
        batch = put_batch(next(batches))
        t0 = time.monotonic()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        _wait(metrics["loss"])
        dt = time.monotonic() - t0
        # straggler watchdog (shared with the serving engine; see
        # runtime/watchdog.py for the warmup-exclusion rationale)
        ewma_before = watchdog.ewma  # observe() folds dt in; log the baseline
        if watchdog.observe(dt):
            log.warning("straggler step %d: %.3fs vs EWMA %.3fs",
                        state.step, dt, ewma_before)
        state.measured_steps = watchdog.observed
        state.ewma_step_time = watchdog.ewma
        state.stragglers = watchdog.stragglers
        state.step += 1
        if metrics_hook is not None and state.step % loop_cfg.log_every == 0:
            metrics_hook(state.step, {k: float(v) for k, v in metrics.items()})
        if state.step % loop_cfg.ckpt_every == 0 or \
                state.step == loop_cfg.total_steps:
            ckpt.save(loop_cfg.ckpt_dir, state.step,
                      {"params": params, "opt": opt_state}, shardings)
            if ckpt.is_writer():
                ckpt.cleanup(loop_cfg.ckpt_dir, loop_cfg.keep)
    return params, opt_state, state
