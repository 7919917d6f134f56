"""The DAISM approximate GEMM kernel for Hopper, its plain version and its
ordered oracle.

Replaces the Pallas TPU kernel ``repro/kernels/daism_matmul.py::_kernel``.
The kernel itself is CUDA C++ in ``csrc/daism_matmul.cu`` (design notes and
what bounds it are there); this module binds it with ``ctypes`` and launches
it on PyTorch's current stream. :func:`daism_matmul_plain` computes the same
function with tensor ops, the fused K sweep of
:mod:`~repro_torch.kernels.approx_product` (another f32 summation order).
:func:`daism_matmul_ordered` adds the same products in the kernel's own
order (K chunks of :data:`KC`, ascending), so the kernel must equal it bit
for bit; nothing on the main path calls it.

The kernel has two paths, one function: a tile path for large M and a
split-K path for decode batches and small tile grids; :func:`_plan` holds
the whole rule that picks them (and the split-K path's row tile and columns
a thread). The chunk order makes their bits the same, and makes a row's
bits independent of M.

EXACT is another kernel on the tensor cores (``csrc/exact_gemm.cuh``):
bf16 products are exact in f32 and EXACT's summation order is not part of
its function, so its paths agree within f32 rounding, not bit for bit.
Bytes bound it up to M ~ 128, the bf16 tensor-core rate above. Its paths,
picked by the same :func:`_plan`: ``"tile"`` (TMA-fed ``wgmma`` on 64 x 128
tiles up to M = 64, 128 x 256 above), ``"splitk"`` (the same with K cut
into slices where the tile grid leaves SMs idle, the parts added by a
second pass) and ``"edge"`` (the same kernel with plain zero-filled loads,
for K or N not a multiple of 8 or operands not 16-byte aligned).

:func:`daism_matmul_experts_kernel` runs E such products, one per expert
of an MoE layer, in one launch (an expert grid axis; EXACT is not on it):
each expert's rows are the bits of a 2-D launch on its operands.
:func:`daism_matmul_experts_plain` is the per-expert loop over
:func:`daism_matmul_plain`.

``launches`` counts GEMM calls that launched the kernel (one per call,
whatever the path, one for all the experts of a call), ``sum_launches``
the split-K paths' second pass (the sum of the chunks or K slices), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.config import Variant

from .approx_product import (approx_matmul_tile, compose_products_f32,
                             decompose_bf16_i32)
from .build import load_library

# variant -> the C enum in csrc/approx_product.cuh
VARIANT_IDS = {
    Variant.EXACT: 0, Variant.FLA: 1, Variant.HLA: 2, Variant.PC2: 3,
    Variant.PC3: 4, Variant.PC2_TR: 5, Variant.PC3_TR: 6,
}
BLOCK_M = 64  # the tile path's output tile rows (csrc/daism_matmul.cu kBM)
# The K chunk of the summation order (csrc/daism_matmul.cu kKc): part of
# the function, like flash attention's 128-key tile. Chosen by measurement
# on the H100 (tools/gemm_kc_sweep.py, PERF.md).
KC = 64
# Which path a call takes is a speed choice only (every plan gives the same
# bits), made by measurement on the H100 (PERF.md): split-K up to M = 16, and
# up to M = 128 while the tile grid would give fewer than two blocks an SM
# (k/v, q/o, wi/wg and ffn/wo at a 128-row prefill chunk); the tile path
# above that (the lm_head at M >= 64, every prefill and train GEMM).
SPLIT_K_MAX_M = 128
SPLIT_K_ALWAYS_M = 16
SPLIT_K_TILE_BLOCKS = 2 * 132
# A split-K grid wants this many threads (128 a block) to give each of the
# 132 SMs' 4 schedulers two warps; below it a plan spreads the work thinner.
SPLIT_K_MIN_THREADS = 132 * 4 * 2 * 32
# ... and takes the tile path where its f32 workspace of chunk parts would
# pass this many bytes (only the expert products come near it: Qwen3-MoE's
# 128 experts at M = 16 would need 0.8 GB)
SPLIT_K_MAX_WS_BYTES = 2**28
_MAX_GRID = 65535
# EXACT (csrc/exact_gemm.cuh): tiles of 64 x 128 (one consumer warpgroup)
# or 128 x 256 (two); K in stages of 64. A grid of fewer than EXACT_WAVE
# tiles (one an SM) is cut into K slices until it fills one wave; 128-row
# tiles where M > 64 and each block then still walks EXACT_DEEP_STAGES
# stages a slice (or needs no slices). Measured on the H100 (PERF.md).
EXACT_PATHS = ("tile", "splitk", "edge")
EXACT_BK = 64
EXACT_WAVE = 132
EXACT_DEEP_STAGES = 16

launches = 0
sum_launches = 0
_launch_c = None  # the bound C entry points, set on first use
_experts_c = None


def _bind():
    """Load (building if needed) the library and bind its C function once."""
    global _launch_c
    lib = load_library("daism_matmul")
    chunk = lib.daism_matmul_chunk
    chunk.argtypes, chunk.restype = [], ctypes.c_int
    if chunk() != KC:
        raise RuntimeError(f"csrc/daism_matmul.cu sums K in chunks of "
                           f"{chunk()}, this module in chunks of {KC}")
    fn = lib.daism_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    experts = lib.daism_matmul_experts
    experts.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
    experts.restype = ctypes.c_int
    global _experts_c
    _experts_c = experts
    _launch_c = fn
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


def _plan(m: int, k: int, n: int, variant: Variant,
          path: Optional[str] = None, kc: int = KC,
          aligned: bool = True, experts: int = 1) -> Optional[tuple]:
    """How an (M, K) @ (K, N) call runs. ``path`` forces a path; ``None``
    picks it by shape. The one rule for every variant; a speed choice only
    (PERF.md has the measurements).

    Approximate variants: ``None`` for the tile path, else the split-K
    path's (rows a block, columns a thread); ``path`` is ``"tile"`` or
    ``"splitk"`` (see :data:`SPLIT_K_MAX_M`). The split-K plan takes 4
    columns a thread (their w as one 8-byte load, each x field shared by 4
    products) while the grid keeps :data:`SPLIT_K_MIN_THREADS`, else 1 (4x
    the threads); row tiles of 4 (a decode batch) or 16, and of 1 for one
    row or a narrow GEMM (k/v at decode), which gives each row its own
    blocks. ``experts`` products in one launch count as that many times
    the blocks and threads; the tile path is taken where the split-K
    workspace would pass :data:`SPLIT_K_MAX_WS_BYTES`.

    EXACT: ``(path, tile rows, K slices)``, ``path`` one of
    :data:`EXACT_PATHS`. ``aligned`` says both operands start on 16 bytes;
    with K and N multiples of 8 the TMA paths take the call, else the edge
    path. The K slices fill one wave of :data:`EXACT_WAVE` blocks where
    the tile grid is smaller (decode, the 128-row prefill chunk), with no
    empty slice; tiles of 128 rows where M > 64 and the slices would keep
    :data:`EXACT_DEEP_STAGES` stages each (or are not needed), else of 64
    (decode, the prefill chunk, k/v at M = 2048). Forcing ``"tile"`` takes
    one slice, ``"splitk"`` at least two where K has two stages, ``"edge"``
    the default's slices."""
    if Variant(variant) is Variant.EXACT:
        return _exact_plan(m, k, n, path, aligned)
    chunks = -(-k // kc)
    if path is None:
        tile_blocks = experts * -(-m // BLOCK_M) * -(-n // BLOCK_M)
        split = m <= SPLIT_K_MAX_M and (
            m <= SPLIT_K_ALWAYS_M or tile_blocks < SPLIT_K_TILE_BLOCKS) and (
            chunks < 2 or 4 * chunks * experts * m * n <= SPLIT_K_MAX_WS_BYTES)
    elif path in ("tile", "splitk"):
        split = path == "splitk"
    else:
        raise ValueError(f"path must be 'tile' or 'splitk', got {path!r}")
    if not split:
        return None
    if m <= 1 or experts * n * chunks * -(-m // 4) < SPLIT_K_MIN_THREADS:
        return 1, 1
    rows = 4 if m <= 4 else 16
    wide = (experts * -(-n // 4) * chunks * -(-m // rows)
            >= SPLIT_K_MIN_THREADS)
    return rows, 4 if wide else 1


def _exact_plan(m: int, k: int, n: int, path: Optional[str],
                aligned: bool) -> tuple:
    """:func:`_plan` for EXACT: ``(path, tile rows, K slices)``."""
    if path is not None and path not in EXACT_PATHS:
        raise ValueError(f"EXACT's path must be one of {EXACT_PATHS}, got "
                         f"{path!r}")
    tma = aligned and k % 8 == 0 and n % 8 == 0
    if path in ("tile", "splitk") and not tma:
        raise ValueError(f"the TMA paths need K and N multiples of 8 and "
                         f"16-byte-aligned operands, got ({m}, {k}, {n})")
    stages = max(1, -(-k // EXACT_BK))
    big = max(1, -(-m // 128) * -(-n // 256))
    big_slices = max(1, EXACT_WAVE // big)
    if m > 64 and (big_slices == 1 or stages >= EXACT_DEEP_STAGES * big_slices):
        rows, tiles = 128, big
    else:
        rows, tiles = 64, max(1, -(-m // 64) * -(-n // 128))
    slices = max(1, min(EXACT_WAVE // tiles, stages))
    if path == "tile":
        slices = 1
    elif path == "splitk":
        slices = max(slices, min(2, stages))
    slices = -(-stages // -(-stages // slices))  # no empty slice
    if path is None:
        path = "edge" if not tma else "tile" if slices == 1 else "splitk"
    return path, rows, slices


def daism_matmul_kernel(a: torch.Tensor, w: torch.Tensor,
                        variant: Variant = Variant.PC3_TR) -> torch.Tensor:
    """(M, K) @ (K, N) bf16 CUDA tensors -> (M, N) f32 via the CUDA kernel,
    on the path :func:`_plan` picks by shape.

    Raises on anything the kernel does not take: operands off the card,
    another dtype, a rank other than 2, non-contiguous storage.
    """
    return _launch(a, w, variant)


def _launch(a: torch.Tensor, w: torch.Tensor, variant: Variant,
            path: Optional[str] = None) -> torch.Tensor:
    """:func:`daism_matmul_kernel` with the path forced (``"tile"`` or
    ``"splitk"``, and for EXACT also ``"edge"``) or, for ``None``, picked by
    :func:`_plan`. An approximate variant's paths give the same bits, and
    EXACT's agree within f32 summation order (the tests and chip_smoke.py
    force each to show it)."""
    global launches, sum_launches
    _check_operands(a, w)
    if a.device.type != "cuda" or w.device != a.device:
        raise ValueError(f"daism_matmul_kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {w.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("daism_matmul_kernel needs contiguous operands")
    variant = Variant(variant)
    m, k = a.shape
    n = w.shape[1]
    if variant is Variant.EXACT:
        aligned = a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
        exact_path, rows, parts = _plan(m, k, n, variant, path,
                                        aligned=aligned)
        grid = (-(-n // (2 * rows)), parts)
        rows = -rows if exact_path == "edge" else rows
        cols = parts
    else:
        plan = _plan(m, k, n, variant, path)
        parts = -(-k // KC) if plan else 1
        grid = (parts, -(-m // plan[0])) if plan else (-(-m // BLOCK_M),)
        rows, cols = plan or (0, 0)
    if max(m, k, n) >= 2**31 or max(grid) > _MAX_GRID:
        raise ValueError(f"shape ({m}, {k}, {n}) exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    second_pass = parts > 1
    ws = (torch.empty((parts, m, n), dtype=torch.float32, device=a.device)
          if second_pass else None)
    fn = _launch_c or _bind()
    args = (a.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, k, n,
            VARIANT_IDS[variant], rows, cols,
            torch.cuda.current_stream(a.device).cuda_stream)
    if a.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the C launch runs on the calling thread's current device
        with torch.cuda.device(a.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"daism_matmul launch failed: CUDA error {err}")
    launches += 1
    sum_launches += second_pass
    return out


def _check_expert_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"expert GEMMs take (E, C, K) @ (E, K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("Pallas DAISM kernel is bfloat16-only; f32 uses the "
                         "dual-plane jnp backend")


def daism_matmul_experts_kernel(x: torch.Tensor, w: torch.Tensor,
                                variant: Variant = Variant.PC3_TR
                                ) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) bf16 CUDA tensors -> (E, C, N) f32: every
    expert's product in one launch of the kernel, on the path :func:`_plan`
    picks for the shape and E. Expert ``e``'s rows are the bits of
    ``daism_matmul_kernel(x[e], w[e])``.

    Each expert's ``x[e]`` and ``w[e]`` must be row-major; the expert
    strides are free, and ``x``'s may be 0 (one (C, K) operand broadcast to
    every expert, as ``expand`` makes it), so nothing is copied. EXACT is
    refused: exact expert sites run the plain batched product.
    """
    return _launch_experts(x, w, variant)


def _row_major(t: torch.Tensor) -> bool:
    """Each (rows, cols) matrix of the 3-D ``t`` is row-major."""
    return (t.shape[2] <= 1 or t.stride(2) == 1) and (
        t.shape[1] <= 1 or t.stride(1) == t.shape[2])


def _launch_experts(x: torch.Tensor, w: torch.Tensor, variant: Variant,
                    path: Optional[str] = None) -> torch.Tensor:
    """:func:`daism_matmul_experts_kernel` with the path forced (``"tile"``
    or ``"splitk"``) or, for ``None``, picked by :func:`_plan`."""
    global launches, sum_launches
    _check_expert_operands(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"daism_matmul_experts_kernel needs both operands on "
                         f"one CUDA device, got {x.device} and {w.device}")
    if not (_row_major(x) and _row_major(w)):
        raise ValueError("daism_matmul_experts_kernel needs each expert's "
                         "operands row-major")
    variant = Variant(variant)
    if variant is Variant.EXACT:
        raise ValueError("the expert GEMM kernel runs the six approximate "
                         "variants; exact expert sites use the plain batched "
                         "product")
    e, m, k = x.shape
    n = w.shape[2]
    plan = _plan(m, k, n, variant, path, experts=e)
    parts = -(-k // KC) if plan else 1
    grid = ((parts, e * -(-m // plan[0])) if plan
            else (-(-m // BLOCK_M), e))
    if max(m, k, n) >= 2**31 or max(grid) > _MAX_GRID:
        raise ValueError(f"shape ({e}, {m}, {k}, {n}) exceeds the kernel's "
                         "grid")
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    second_pass = parts > 1
    ws = (torch.empty((parts, e, m, n), dtype=torch.float32, device=x.device)
          if second_pass else None)
    if _experts_c is None:
        _bind()
    rows, cols = plan or (0, 0)
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, e, m, k, n,
            x.stride(0) if e > 1 else 0, w.stride(0) if e > 1 else 0,
            VARIANT_IDS[variant], rows, cols,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        err = _experts_c(*args)
    else:  # the C launch runs on the calling thread's current device
        with torch.cuda.device(x.device):
            err = _experts_c(*args)
    if err != 0:
        raise RuntimeError(f"daism_matmul_experts launch failed: CUDA error "
                           f"{err}")
    launches += 1
    sum_launches += second_pass
    return out


def daism_matmul_experts_plain(x: torch.Tensor, w: torch.Tensor,
                               variant: Variant = Variant.PC3_TR
                               ) -> torch.Tensor:
    """The expert kernel's function in plain torch, on any device: the loop
    of :func:`daism_matmul_plain` over the experts, (E, C, K) @ (E, K, N)
    bf16 -> (E, C, N) f32."""
    _check_expert_operands(x, w)
    return torch.stack([daism_matmul_plain(x[i], w[i], variant)
                        for i in range(x.shape[0])])


def daism_matmul_plain(a: torch.Tensor, w: torch.Tensor,
                       variant: Variant = Variant.PC3_TR) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: (M, K) @ (K, N)
    bf16 -> (M, N) f32. EXACT is an f32 matmul of the bf16 values."""
    _check_operands(a, w)
    variant = Variant(variant)
    if variant is Variant.EXACT:
        return a.to(torch.float32) @ w.to(torch.float32)
    return approx_matmul_tile(a, w, variant)


def daism_matmul_ordered(a: torch.Tensor, w: torch.Tensor,
                         variant: Variant = Variant.PC3_TR) -> torch.Tensor:
    """The kernel's function in its own summation order, on any device:
    (M, K) @ (K, N) bf16 -> (M, N) f32, for the six approximate variants.

    ``total = 0``; for each K chunk of :data:`KC` ascending, ``part = 0``,
    ``part += product`` for k ascending, ``total += part``, every add an f32
    add. The per-element products come from
    :mod:`~repro_torch.kernels.approx_product` (bit-exact against
    ``kernels/ref.py``), 16 columns of K at a time. A row's result
    depends on that row of ``a`` and on ``w`` only. The kernel equals this
    bit for bit on either path; nothing on the main path calls it (it loops
    over K in Python).
    """
    _check_operands(a, w)
    variant = Variant(variant)
    if variant is Variant.EXACT:
        raise ValueError("daism_matmul_ordered is the approximate variants' "
                         "oracle; EXACT's summation order is not part of its "
                         "function")
    m, k = a.shape
    n = w.shape[1]
    xf, wf = decompose_bf16_i32(a), decompose_bf16_i32(w)
    total = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for c0 in range(0, k, KC):
        c1 = min(c0 + KC, k)
        part = torch.zeros_like(total)
        for lo in range(c0, c1, 16):
            hi = min(lo + 16, c1)
            prods = compose_products_f32(
                tuple(f[:, lo:hi, None] for f in xf),
                tuple(f[None, lo:hi, :] for f in wf), variant)
            for i in range(hi - lo):
                part = part + prods[:, i]
        total = total + part
    return total
