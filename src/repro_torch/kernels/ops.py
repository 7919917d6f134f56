"""Public wrapper around the DAISM GEMM kernel (device dispatch)."""
from __future__ import annotations

import torch

from repro_torch.core.config import DaismConfig
from repro_torch.roofline.flops import note_kernel_call

from . import daism_matmul as _dm


def daism_matmul_pallas(a: torch.Tensor, w: torch.Tensor,
                        cfg: DaismConfig) -> torch.Tensor:
    """(M, K) @ (K, N) bf16 -> (M, N) f32 under ``cfg.variant``.

    The operands' device picks the implementation: CUDA tensors launch the
    CUDA kernel (which masks ragged edges itself, so nothing is padded) and
    CPU tensors take its plain version. There is no fallback between them;
    both raise ``ValueError`` on non-bf16 operands. ``meta`` tensors (a
    shape-only trace) get a ``meta`` result: nothing runs, and the call is
    noted in an open ``roofline.flops.Tally`` (no launch is counted).
    """
    if a.device.type == "meta" and w.device.type == "meta":
        _dm._check_operands(a, w)
        out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32,
                          device="meta")
        note_kernel_call("daism_matmul", (a, w), out)
        return out
    if a.device.type == "cuda":
        return _dm.daism_matmul_kernel(a, w, cfg.variant)
    if a.device.type == "cpu" and w.device.type == "cpu":
        return _dm.daism_matmul_plain(a, w, cfg.variant)
    raise ValueError(f"daism_matmul_pallas: unsupported devices {a.device} / "
                     f"{w.device}")


def daism_expert_matmul_pallas(x: torch.Tensor, w: torch.Tensor,
                               cfg: DaismConfig) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) bf16 -> (E, C, N) f32 under ``cfg.variant``:
    every expert in one launch of the CUDA kernel for CUDA tensors (``x``
    may be an expert-broadcast view), the per-expert plain version for CPU
    tensors, a ``meta`` result for ``meta`` tensors (noted as above). No
    fallback between them."""
    if x.device.type == "meta" and w.device.type == "meta":
        _dm._check_expert_operands(x, w)
        out = torch.empty((x.shape[0], x.shape[1], w.shape[2]),
                          dtype=torch.float32, device="meta")
        note_kernel_call("daism_matmul_experts", (x, w), out)
        return out
    if x.device.type == "cuda":
        return _dm.daism_matmul_experts_kernel(x, w, cfg.variant)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return _dm.daism_matmul_experts_plain(x, w, cfg.variant)
    raise ValueError(f"daism_expert_matmul_pallas: unsupported devices "
                     f"{x.device} / {w.device}")
