"""The DAISM approximate GEMM kernel for Hopper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/daism_matmul.py::_kernel``.
The kernel itself is CUDA C++ in ``csrc/daism_matmul.cu`` (design notes and
what bounds it are there); this module binds it with ``ctypes`` and launches
it on PyTorch's current stream. :func:`daism_matmul_plain` computes the same
function with tensor ops, the fused K sweep of
:mod:`~repro_torch.kernels.approx_product`.

``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.config import Variant

from .approx_product import approx_matmul_tile
from .build import load_library

# variant -> the C enum in csrc/approx_product.cuh
VARIANT_IDS = {
    Variant.EXACT: 0, Variant.FLA: 1, Variant.HLA: 2, Variant.PC2: 3,
    Variant.PC3: 4, Variant.PC2_TR: 5, Variant.PC3_TR: 6,
}
BLOCK_M = 64  # the kernel's output tile rows (csrc/daism_matmul.cu kBM)
_MAX_GRID_Y = 65535

launches = 0
_launch = None  # the bound C entry point, set on first use


def _bind():
    """Load (building if needed) the library and bind its C function once."""
    global _launch
    fn = load_library("daism_matmul").daism_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _launch = fn
    return fn


def _check_operands(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"daism_matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"@ {tuple(w.shape)}")
    if a.shape[1] != w.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ {tuple(w.shape)}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("Pallas DAISM kernel is bfloat16-only; f32 uses the "
                         "dual-plane jnp backend")


def daism_matmul_kernel(a: torch.Tensor, w: torch.Tensor,
                        variant: Variant = Variant.PC3_TR) -> torch.Tensor:
    """(M, K) @ (K, N) bf16 CUDA tensors -> (M, N) f32 via the CUDA kernel.

    Raises on anything the kernel does not take: operands off the card,
    another dtype, a rank other than 2, non-contiguous storage.
    """
    global launches
    _check_operands(a, w)
    if a.device.type != "cuda" or w.device != a.device:
        raise ValueError(f"daism_matmul_kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {w.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("daism_matmul_kernel needs contiguous operands")
    m, k = a.shape
    n = w.shape[1]
    if max(m, k, n) >= 2**31 or -(-m // BLOCK_M) > _MAX_GRID_Y:
        raise ValueError(f"shape ({m}, {k}, {n}) exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = _launch or _bind()
    args = (a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
            VARIANT_IDS[Variant(variant)],
            torch.cuda.current_stream(a.device).cuda_stream)
    if a.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the C launch runs on the calling thread's current device
        with torch.cuda.device(a.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"daism_matmul launch failed: CUDA error {err}")
    launches += 1
    return out


def daism_matmul_plain(a: torch.Tensor, w: torch.Tensor,
                       variant: Variant = Variant.PC3_TR) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: (M, K) @ (K, N)
    bf16 -> (M, N) f32. EXACT is an f32 matmul of the bf16 values."""
    _check_operands(a, w)
    variant = Variant(variant)
    if variant is Variant.EXACT:
        return a.to(torch.float32) @ w.to(torch.float32)
    return approx_matmul_tile(a, w, variant)
