"""Step-time EWMA straggler watchdog.

Shared by the fault-tolerant train loop (runtime/fault_tolerance.py) and
the serving engine (repro_torch/serve): both run step loops where a
slow host (or a surprise recompile) stretches every step, and both want
the same detection rule — flag steps slower than ``factor`` x the running
mean, excluding compile-dominated warmup steps from the estimate.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StepWatchdog:
    factor: float = 3.0      # straggler threshold vs. the EWMA
    alpha: float = 0.1       # EWMA smoothing
    warmup: int = 1          # leading steps excluded (compile-dominated)

    ewma: float = 0.0
    stragglers: int = 0
    observed: int = 0

    def observe(self, dt: float) -> bool:
        """Feed one step time (seconds). Returns True if it is a straggler.

        The first ``warmup`` steps are excluded entirely — a 10-100x
        compile step would otherwise poison the EWMA and mask real
        stragglers for many steps.
        """
        self.observed += 1
        if self.observed <= self.warmup:
            return False
        if self.ewma == 0.0:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma
        if slow:
            self.stragglers += 1
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow
