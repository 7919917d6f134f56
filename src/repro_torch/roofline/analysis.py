"""Three-term roofline of a step on one NVIDIA H100, from a ``meta`` trace.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / link_bw

The port of ``repro/roofline/analysis.py``. The reference reads XLA's
``cost_analysis`` and parses the optimized HLO for its collectives; the
port has neither: :func:`analyze` takes a :class:`~repro_torch.roofline.flops.Tally`
(the eager program's FLOPs and bytes on one rank) and the rank's group
calls from ``parallel.sharding.record_collectives``, weighed by the
reference's ring factors (:func:`_wire_factor`, a copy):

    all-reduce      2 (N-1)/N x bytes
    all-gather      (N-1)/N x result bytes
    reduce-scatter  (N-1)/N x operand bytes
    all-to-all      (N-1)/N x bytes
    collective-permute  1 x bytes

Hardware constants: the NVIDIA H100 SXM5 80 GB datasheet at 700 W, not
measurements: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3,
450 GB/s NVLink 4 in one direction a GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores / card (datasheet)
HBM_BW = 3.35e12             # bytes/s / card (datasheet)
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction (datasheet)


def _wire_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    r = (n - 1) / n
    return {"all-reduce": 2 * r, "all-gather": r, "reduce-scatter": r,
            "all-to-all": r, "collective-permute": 1.0}[op]


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0

    def add(self, op: str, b: float):
        self.wire_bytes += b
        self.by_op[op] = self.by_op.get(op, 0.0) + b
        self.count += 1


def collective_stats(calls: Iterable) -> CollectiveStats:
    """The wire bytes of a rank's group calls
    (``parallel.sharding.CollectiveCall``s), by op: the port's
    ``collective_bytes_from_hlo``."""
    stats = CollectiveStats()
    for c in calls:
        stats.add(c.op, c.wire_bytes)
    return stats


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / (FLOPs x chips)
    peak_fraction: float         # compute_s / max(all terms)
    memory_per_device_gb: float
    collective_by_op: Dict[str, float]

    def terms(self) -> Dict[str, float]:
        return {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}


def analyze(tally, calls, *, arch: str, shape: str, mesh_name: str,
            n_chips: int, model_flops: float,
            memory_per_device: Optional[float] = None,
            flops_per_device: Optional[float] = None) -> Roofline:
    """The terms of one rank's step: its tally's bytes (and FLOPs, unless
    ``flops_per_device`` is given: the dry-run's global count over the
    chips) and its group calls' wire bytes."""
    flops = (float(tally.flops) if flops_per_device is None
             else float(flops_per_device))
    byts = float(tally.bytes)
    stats = collective_stats(calls)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    coll_s = stats.wire_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    total = max(max(terms.values()), 1e-30)
    if memory_per_device is None:
        memory_per_device = float(tally.peak_bytes)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=flops, bytes_per_device=byts,
        wire_bytes_per_device=stats.wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * n_chips)) if flops else 0.0,
        peak_fraction=compute_s / total,
        memory_per_device_gb=memory_per_device / 2**30,
        collective_by_op=stats.by_op,
    )


def model_flops_estimate(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (forward) with N = active params.

    MoE: N counts topk/n_experts of expert params (active). Decode: D = one
    token per step x batch. (The reference's, over the port's
    ``param_specs``: the same paths and shapes.)
    """
    import math

    from repro_torch.models.registry import build_model

    model = build_model(cfg, device="cpu")  # plans only; allocates nothing
    n_total = 0
    n_expert = 0
    for keys, spec in model.param_specs().items():
        n = math.prod(spec[0])
        if any(k in keys for k in ("w_in", "w_gate", "w_out")) and cfg.n_experts:
            n_expert += n
        else:
            n_total += n
    active = n_total + (n_expert * cfg.topk // max(cfg.n_experts, 1))
    tokens = batch * (1 if shape_kind == "decode" else seq)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * active * tokens
