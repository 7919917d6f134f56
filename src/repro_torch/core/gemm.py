"""Approximate GEMM: exact accumulation of DAISM-approximate scalar products.

``out[m, n] = sum_k approx(a[m, k] * w[k, n])`` where the per-element product
uses one of the Table-1 multiplier variants and the reduction is exact
(DAISM's accumulator is an exact adder, paper §4.1).

Backends
  * ``jnp``    — elementwise bit ops, K-chunked to bound the (M, Kc, N)
                 intermediate. The reference semantics.
  * ``lut``    — bf16 gather fast path (bit-identical, see core/lut.py).
  * ``pallas`` — the CUDA kernel on CUDA tensors, its plain tile version on
                 CPU tensors (kernels/ops.py).
  * ``exact``  — plain matmul (deployment path).

``conv2d_im2col`` lowers an NHWC convolution onto the same GEMM, as the
accelerator runs convolutions (kernels flattened into SRAM rows).

Autodiff: the forward pass uses the approximate product. The backward pass is
straight-through (exact matmul gradients) by default, or routed through the
approximate GEMM as well with ``backward='approx'``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F

from .bitops import round_up as _round_up
from .config import Backend, DaismConfig, torch_dtype
from .floatmul import approx_mul_to_f32
from .lut import approx_mul_to_f32_lut


def _product_fn(cfg: DaismConfig) -> Callable:
    if cfg.backend is Backend.LUT:
        return functools.partial(approx_mul_to_f32_lut, variant=cfg.variant)
    return functools.partial(approx_mul_to_f32, variant=cfg.variant)


def _matmul_chunked(a: torch.Tensor, w: torch.Tensor,
                    cfg: DaismConfig) -> torch.Tensor:
    """(M, K) x (K, N) -> (M, N) f32, chunking K to bound peak memory."""
    m, k = a.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ {tuple(w.shape)}")
    prod = _product_fn(cfg)
    kc = max(min(cfg.k_chunk, k), 1)
    k_pad = _round_up(k, kc)
    if k_pad != k:  # zero-padding is exact: approx(0 * w) == 0
        a = F.pad(a, (0, k_pad - k))
        w = F.pad(w, (0, 0, 0, k_pad - k))
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for lo in range(0, k_pad, kc):
        p = prod(a[:, lo:lo + kc, None], w[None, lo:lo + kc, :])  # (M, Kc, N)
        acc = acc + p.sum(dim=1)
    return acc


def _matmul_fwd_impl(a: torch.Tensor, w: torch.Tensor,
                     cfg: DaismConfig) -> torch.Tensor:
    if cfg.exact:
        return a.to(torch.float32) @ w.to(torch.float32)
    if cfg.backend is Backend.PALLAS:
        from repro_torch.kernels import ops as kops  # local import: avoid cycle

        return kops.daism_matmul_pallas(a, w, cfg)
    return _matmul_chunked(a, w, cfg)


class _DaismMatmul(torch.autograd.Function):
    """Approximate forward; straight-through or approximate backward."""

    @staticmethod
    def forward(ctx, a, w, cfg: DaismConfig):
        ctx.save_for_backward(a, w)
        ctx.cfg = cfg
        return _matmul_fwd_impl(a, w, cfg)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        cfg = ctx.cfg
        g = g.to(torch.float32)
        if cfg.backward == "approx" and not cfg.exact:
            # same approximate numerics for the gradient GEMMs
            da = _matmul_fwd_impl(g.to(a.dtype), w.t().to(a.dtype).contiguous(),
                                  cfg)
            dw = _matmul_fwd_impl(a.t().to(a.dtype).contiguous(), g.to(a.dtype),
                                  cfg)
        else:  # straight-through: exact gradients
            da = g @ w.to(torch.float32).t()
            dw = a.to(torch.float32).t() @ g
        return da.to(a.dtype), dw.to(w.dtype), None


def daism_matmul(a: torch.Tensor, w: torch.Tensor,
                 cfg: DaismConfig) -> torch.Tensor:
    """2-D approximate matmul, (M, K) @ (K, N) -> (M, N) in ``cfg.accum_dtype``."""
    out = _DaismMatmul.apply(a, w, cfg)
    if cfg.calibrated and not cfg.exact:
        from .lut import shrinkage_factor  # bf16-table statistic

        out = out * (1.0 / shrinkage_factor(cfg.variant))
    return out.to(torch_dtype(cfg.accum_dtype))


def _expert_fwd_impl(x: torch.Tensor, w: torch.Tensor,
                     cfg: DaismConfig) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) -> (E, C, N) f32, expert by expert (one kernel
    launch for all of them on the ``pallas`` backend)."""
    if cfg.backend is Backend.PALLAS and not cfg.exact:
        from repro_torch.kernels import ops as kops  # local import: avoid cycle

        return kops.daism_expert_matmul_pallas(x, w, cfg)
    return torch.stack([_matmul_fwd_impl(x[i], w[i], cfg)
                        for i in range(x.shape[0])])


class _DaismExpertMatmul(torch.autograd.Function):
    """:class:`_DaismMatmul` over a leading expert axis."""

    @staticmethod
    def forward(ctx, x, w, cfg: DaismConfig):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        return _expert_fwd_impl(x, w, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        g = g.to(torch.float32)
        wt = w.transpose(1, 2)
        xt = x.transpose(1, 2)
        if cfg.backward == "approx" and not cfg.exact:
            dx = _expert_fwd_impl(g.to(x.dtype), wt.to(x.dtype).contiguous(),
                                  cfg)
            dw = _expert_fwd_impl(xt.to(x.dtype).contiguous(), g.to(x.dtype),
                                  cfg)
        else:  # straight-through: exact gradients
            dx = g @ wt.to(torch.float32)
            dw = xt.to(torch.float32) @ g
        return dx.to(x.dtype), dw.to(w.dtype), None


def daism_expert_matmul(x: torch.Tensor, w: torch.Tensor,
                        cfg: DaismConfig) -> torch.Tensor:
    """:func:`daism_matmul` of every expert, (E, C, K) @ (E, K, N) ->
    (E, C, N) in ``cfg.accum_dtype``: expert ``e``'s result is
    ``daism_matmul(x[e], w[e], cfg)`` (the reference ``vmap``s that over
    the experts), with the same backward."""
    out = _DaismExpertMatmul.apply(x, w, cfg)
    if cfg.calibrated and not cfg.exact:
        from .lut import shrinkage_factor  # bf16-table statistic

        out = out * (1.0 / shrinkage_factor(cfg.variant))
    return out.to(torch_dtype(cfg.accum_dtype))


def daism_dot(x: torch.Tensor, w: torch.Tensor,
              cfg: DaismConfig) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x``: (..., K) @ (K, N) -> (..., N).

    The deployment path (cfg.exact) keeps ``jnp.dot``'s dtype promotion;
    approximate paths accumulate in f32 then cast to ``cfg.accum_dtype``.
    """
    if cfg.exact:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    lead = x.shape[:-1]
    k = x.shape[-1]
    out = daism_matmul(x.reshape(-1, k), w, cfg)
    return out.reshape(*lead, w.shape[-1])


def _same_pads(size: int, k: int, stride: int):
    """(low, high) zero padding of XLA's ``SAME`` along one axis: the
    output has ``ceil(size / stride)`` positions, the odd cell goes high."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_im2col(x: torch.Tensor, kernel: torch.Tensor, cfg: DaismConfig,
                  *, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """NHWC conv via im2col + DAISM GEMM: how the accelerator executes convs
    (kernels flattened into SRAM rows, paper Fig 4). kernel: (kh, kw, cin,
    cout) (HWIO).

    Exact configs run the library convolution (``F.conv2d``, never in TF32;
    the reference runs ``lax.conv_general_dilated``) and keep ``x``'s
    dtype. Approximate
    configs take the patches with their features ordered (cin, kh, kw), the
    order of the reference's ``conv_general_dilated_patches`` and of
    ``F.unfold``, reorder the kernel to match, and run
    :func:`daism_matmul` (output in ``cfg.accum_dtype``).
    """
    kh, kw, cin, cout = kernel.shape
    nb, h, wd = x.shape[0], x.shape[1], x.shape[2]
    xn = x.permute(0, 3, 1, 2)  # NCHW
    if padding == "SAME":
        (top, bottom), (left, right) = (_same_pads(h, kh, stride),
                                        _same_pads(wd, kw, stride))
        xn = F.pad(xn, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    ho = (xn.shape[2] - kh) // stride + 1
    wo = (xn.shape[3] - kw) // stride + 1
    if cfg.exact:
        # cuDNN runs f32 convolutions in TF32 (10-bit mantissas) while
        # torch.backends.cudnn.allow_tf32 is on, PyTorch's default; the
        # reference's f32 conv is full f32, so TF32 is off for this call
        # alone (bf16 inputs are unaffected by the flag)
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            out = F.conv2d(xn, kernel.permute(3, 2, 0, 1), stride=stride)
        return out.permute(0, 2, 3, 1)
    patches = F.unfold(xn, (kh, kw), stride=stride)  # (N, cin*kh*kw, Ho*Wo)
    feat = cin * kh * kw
    a = patches.transpose(1, 2).reshape(nb * ho * wo, feat).contiguous()
    kmat = kernel.permute(2, 0, 1, 3).reshape(feat, cout).contiguous()
    out = daism_matmul(a, kmat, cfg)
    return out.reshape(nb, ho, wo, cout)
