"""Quickstart on the PyTorch port: the DAISM approximate multiplier in 30
lines (``examples/quickstart.py`` on ``repro_torch``).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The ``pallas`` backend is the hand-written CUDA kernel on the card (its
plain version with ``--device cpu``).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (ALL_VARIANTS, Backend, DaismConfig, Variant,
                              approx_mul, daism_matmul)
from repro_torch.runtime.device import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument("--device", default="cuda",
                    help="where the GEMMs run (cuda | cpu)")
dev = resolve_device(parser.parse_args().device)

# 1. scalar approximate multiplication (paper core concept) -------------
x = torch.tensor(1.375, dtype=torch.bfloat16)
w = torch.tensor(-2.5, dtype=torch.bfloat16)
print(f"exact        : {float(x) * float(w):+.6f}")
for v in ALL_VARIANTS:
    print(f"{v.value:8s}     : {float(approx_mul(x, w, v)):+.6f}")

# 2. approximate GEMM with exact accumulation ---------------------------
rng = np.random.default_rng(0)
a = torch.tensor(rng.normal(size=(8, 64)), dtype=torch.bfloat16, device=dev)
b = torch.tensor(rng.normal(size=(64, 8)), dtype=torch.bfloat16, device=dev)
exact = a.float() @ b.float()
for backend in (Backend.JNP, Backend.LUT, Backend.PALLAS):
    cfg = DaismConfig(variant=Variant.PC3_TR, backend=backend)
    out = daism_matmul(a, b, cfg)
    rel = (out - exact).abs().mean() / exact.abs().mean()
    print(f"GEMM {backend.value:6s}: mean rel err vs exact = {float(rel):.4f}")

# 3. it differentiates (straight-through backward) ----------------------
cfg = DaismConfig(variant=Variant.PC3_TR)
wg = b.clone().requires_grad_(True)
(daism_matmul(a, wg, cfg) ** 2).sum().backward()
print("grad ok:", tuple(wg.grad.shape),
      bool(torch.isfinite(wg.grad.float()).all()))
