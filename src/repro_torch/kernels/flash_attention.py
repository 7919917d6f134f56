"""Flash attention for Hopper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::_kernel``
(entry ``flash_attention``, wrapper ``flash_attention_bhsd``): fused
online-softmax attention whose QK and PV contractions run exact (f32) or
through the DAISM approximate product, with p rounded to bf16 before the
approximate PV. The kernel itself is CUDA C++ in ``csrc/flash_attention.cu``
(design notes and what bounds it are there); this module binds it with
``ctypes`` and launches it on PyTorch's current stream.

* :func:`flash_attention_plain` computes the same function with tensor ops,
  on any device: the same KV-tile sequence as the TPU kernel (every query
  row at once; a row's arithmetic does not depend on its query tile), with
  QK and PV through :func:`~repro_torch.kernels.approx_product.approx_matmul_tile`.
* :func:`flash_attention` / :func:`flash_attention_bhsd` take (BH, S, D) /
  (B, S, H, D) tensors. CUDA tensors launch the kernel (which maps the
  grouped-query heads and masks the ragged edges itself) or raise; CPU
  tensors take the plain version.

``launches`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.config import Variant, dtype_name, torch_dtype

from .approx_product import approx_matmul_tile
from .build import load_library
from .daism_matmul import VARIANT_IDS

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
KERNEL_BLOCK_Q = 64  # the CUDA kernels' query tile (csrc/flash_attention.cu kBQ)
KERNEL_BLOCK_K = 128  # the CUDA kernel's KV tile (csrc/flash_attention.cu kBK)
KERNEL_MAX_D = 256  # the largest head dim the CUDA kernels take (kMaxD)
# flash_fwd_tc (bf16 exact): the head dim in 16-column MMA steps, KD of them
# (TcTile kDp = 16 KD, zero-padded); launch_tc rounds KD above
# TC_MAX_REG_Q_STEPS up to these, and such dims keep q in shared memory
# and walk keys in tiles of TC_BLOCK_K_QS (TcTile kQs, kKeys)
TC_HEAD_STEP = 16
TC_MAX_REG_Q_STEPS = 8
TC_WIDE_STEPS = (12, 16)
TC_BLOCK_K_QS = 64
_MAX_GRID_Y = 65535

_NEG_INF = -1e30

launches = 0
_launch = None  # the bound C entry point, set on first use


def _bind():
    """Load (building if needed) the library and bind its C function once."""
    global _launch
    fn = load_library("flash_attention").flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch = fn
    return fn


def _variant(variant, dtype) -> Optional[Variant]:
    """``None`` for exact attention, else the approximate variant; raises
    the reference's error for an approximate variant on non-bf16 inputs."""
    if variant is None:
        return None
    variant = Variant(variant)
    if variant is Variant.EXACT:
        return None
    if dtype != torch.bfloat16:
        raise ValueError(
            "flash attention with a DAISM variant is bfloat16-only "
            f"(got {dtype_name(dtype)}); run the site exact or "
            "switch the compute dtype")
    return variant


def kernel_tiles(d: int, dtype, variant=None) -> tuple:
    """(query tile, key tile, head dim as computed) of the CUDA kernel that
    a call on ``dtype`` inputs with ``variant`` launches: ``flash_fwd_tc``
    for bf16 exact (the head dim zero-padded to its MMA steps,
    ``csrc/flash_attention.cu`` ``launch_tc``), else ``flash_fwd`` (the head
    dim whole). Raises as the kernel's entry point does: for a head dim
    past :data:`KERNEL_MAX_D` or an approximate variant off bf16."""
    if not 1 <= d <= KERNEL_MAX_D:
        raise ValueError(f"head dim {d} outside the kernel's 1..{KERNEL_MAX_D}")
    dtype = torch_dtype(dtype)
    if _variant(variant, dtype) is not None or dtype != torch.bfloat16:
        return KERNEL_BLOCK_Q, KERNEL_BLOCK_K, d
    steps = -(-d // TC_HEAD_STEP)
    if steps > TC_MAX_REG_Q_STEPS:
        steps = next(s for s in TC_WIDE_STEPS if steps <= s)
        return KERNEL_BLOCK_Q, TC_BLOCK_K_QS, TC_HEAD_STEP * steps
    return KERNEL_BLOCK_Q, KERNEL_BLOCK_K, TC_HEAD_STEP * steps


def _check_blocks(sq: int, skv: int, block_q: int, block_k: int) -> None:
    if sq % block_q or skv % block_k:
        raise ValueError(f"flash attention needs Sq % block_q == Skv % block_k "
                         f"== 0, got Sq={sq}, Skv={skv}, blocks "
                         f"({block_q}, {block_k})")


def _scale(d: int) -> float:
    """1/sqrt(D) as the reference applies it: a float64 constant rounded
    to f32 when it scales the f32 scores."""
    return float(np.float32(1.0 / np.sqrt(d)))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, kv_len: int = 0,
                          block_q: int = DEFAULT_BLOCK_Q,
                          block_k: int = DEFAULT_BLOCK_K,
                          variant: Optional[Variant] = None) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Skv, D) -> (BH, Sq, D) in q's dtype, on any
    device. Sq % block_q == Skv % block_k == 0 (the bhsd wrapper pads);
    keys at positions >= ``kv_len`` (0: Skv) are masked."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    _check_blocks(sq, skv, block_q, block_k)
    variant = _variant(variant, q.dtype)
    kv_len = kv_len or skv
    scale = _scale(d)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)[:, None]
    m = torch.full((bh, sq), -float("inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    qf = q.to(torch.float32)
    for j in range(skv // block_k):
        kt = k[:, j * block_k:(j + 1) * block_k]
        vt = v[:, j * block_k:(j + 1) * block_k]
        if variant is None:
            s = qf @ kt.to(torch.float32).transpose(1, 2)
        else:
            s = approx_matmul_tile(q, kt.transpose(1, 2), variant)
        s = s * scale
        k_pos = j * block_k + torch.arange(block_k, device=dev)
        mask = None
        if causal:
            mask = k_pos[None, :] <= q_pos
        if kv_len < skv:  # ragged KV: mask padded keys explicitly
            valid = (k_pos < kv_len)[None, :]
            mask = valid if mask is None else mask & valid
        if mask is not None:
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            # a row whose keys so far are all masked has m == -1e30 and
            # p == 1 on masked lanes: zero them so such rows stay empty
            p = torch.where(mask, p, 0.0)
        l = l * corr + p.sum(-1)
        if variant is None:
            pv = p @ vt.to(torch.float32)
        else:
            pv = approx_matmul_tile(p.to(torch.bfloat16), vt, variant)
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True,
                               variant: Optional[Variant] = None,
                               block_q: int = DEFAULT_BLOCK_Q,
                               block_k: int = DEFAULT_BLOCK_K):
    """(B, S, H, D) through the plain version, as the reference's wrapper
    does it: grouped-query heads repeated, (B*H, S, D) layout, both lengths
    padded to their blocks (padded keys masked by ``kv_len``, padded query
    rows dropped)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if kh != h:
        rep = h // kh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = k.transpose(1, 2).reshape(b * h, skv, d)
    vt = v.transpose(1, 2).reshape(b * h, skv, d)
    pq = (-sq) % block_q
    pk = (-skv) % block_k
    if pq:
        qt = torch.nn.functional.pad(qt, (0, 0, 0, pq))
    if pk:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pk))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pk))
    out = flash_attention_plain(qt, kt, vt, causal=causal, kv_len=skv,
                                block_q=block_q, block_k=block_k,
                                variant=variant)
    return out[:, :sq].reshape(b, h, sq, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _launch_kernel(q, k, v, *, b, h, kh, sq, skv, d, kv_len, causal, variant,
                   q_st, k_st, v_st, out, o_st) -> torch.Tensor:
    """Check what the kernel takes and launch it once. ``*_st`` are the
    (batch, sequence, head) element strides of each tensor."""
    global launches
    variant = _variant(variant, q.dtype)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the flash-attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (torch.bfloat16,
                                                           torch.float32):
        raise ValueError(f"the flash-attention kernel takes bf16 or f32 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= KERNEL_MAX_D:
        raise ValueError(f"head dim {d} outside the kernel's 1..{KERNEL_MAX_D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the flash-attention kernel needs the head dim "
                         "contiguous (stride 1)")
    if h % kh or b * h > _MAX_GRID_Y or max(sq, skv) >= 2**31 - KERNEL_BLOCK_K:
        raise ValueError(f"unsupported shape: B={b}, H={h}, KH={kh}, Sq={sq}, "
                         f"Skv={skv}")
    if not 1 <= kv_len <= skv:
        raise ValueError(f"kv_len {kv_len} outside 1..{skv}")
    if sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q_st, *k_st, *v_st, *o_st)
    fn = _launch or _bind()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kh, sq, skv, d, kv_len, int(causal), _scale(d),
            VARIANT_IDS[variant or Variant.EXACT],
            int(q.dtype == torch.float32), strides,
            torch.cuda.current_stream(q.device).cuda_stream)
    if q.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the C launch runs on the calling thread's current device
        with torch.cuda.device(q.device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out


def flash_attention_kernel(q, k, v, *, causal: bool = True, kv_len: int = 0,
                           variant: Optional[Variant] = None) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Skv, D) CUDA tensors -> (BH, Sq, D) via the
    CUDA kernel; raises on what the kernel does not take."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return _launch_kernel(
        q, k, v, b=bh, h=1, kh=1, sq=sq, skv=skv, d=d,
        kv_len=kv_len or skv, causal=causal, variant=variant,
        q_st=(q.stride(0), q.stride(1), 0), k_st=(k.stride(0), k.stride(1), 0),
        v_st=(v.stride(0), v.stride(1), 0), out=out,
        o_st=(out.stride(0), out.stride(1), 0))


def flash_attention_bhsd_kernel(q, k, v, *, causal: bool = True,
                                variant: Optional[Variant] = None
                                ) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, KH, D) CUDA tensors -> (B, Sq, H, D) in
    one launch: the kernel reads the layout through its strides, maps query
    head h to kv head h // (H / KH) and masks the ragged edges, so nothing
    is repeated, transposed or padded."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))  # noqa: E731
    return _launch_kernel(
        q, k, v, b=b, h=h, kh=kh, sq=sq, skv=skv, d=d, kv_len=skv,
        causal=causal, variant=variant, q_st=st(q), k_st=st(k), v_st=st(v),
        out=out, o_st=st(out))


# ---------------------------------------------------------------------------
# Entry points (device dispatch)
# ---------------------------------------------------------------------------


def _require_kernel_block_k(block_k: int) -> None:
    if block_k != KERNEL_BLOCK_K:
        raise ValueError(f"the flash-attention kernel walks keys in tiles of "
                         f"{KERNEL_BLOCK_K} (block_k is part of the approximate "
                         f"function), got block_k={block_k}")


def _require_cpu(*ts) -> None:
    if any(t.device.type != "cpu" for t in ts):
        raise ValueError("flash attention: q, k, v must all be CUDA tensors "
                         f"or all CPU tensors, got {[str(t.device) for t in ts]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int = 0,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    variant: Optional[Variant] = None) -> torch.Tensor:
    """q (BH, Sq, D), k/v (BH, Skv, D) -> (BH, Sq, D) in q's dtype.

    Sq % block_q == Skv % block_k == 0; ``kv_len`` is the true key length
    (keys at positions >= kv_len are masked). ``variant`` runs QK and PV
    through the DAISM product (bf16 inputs only). CUDA tensors launch the
    kernel (``block_k`` must be its 128) or raise; CPU tensors take the
    plain version.
    """
    if q.device.type == "cuda":
        _check_blocks(q.shape[1], k.shape[1], block_q, block_k)
        _require_kernel_block_k(block_k)
        return flash_attention_kernel(q, k, v, causal=causal, kv_len=kv_len,
                                      variant=variant)
    _require_cpu(q, k, v)
    return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                 block_q=block_q, block_k=block_k,
                                 variant=variant)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         variant: Optional[Variant] = None,
                         block_q: int = DEFAULT_BLOCK_Q,
                         block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """(B, S, H, D) layout with grouped-query heads and ragged lengths:
    q (B, Sq, H, D), k/v (B, Skv, KH, D) -> (B, Sq, H, D).

    CUDA tensors launch the kernel once, on the layout as it is; CPU tensors
    take :func:`flash_attention_bhsd_plain`; ``meta`` tensors (a shape-only
    trace, ``analyze.trace_site_graph``) get a ``meta`` result: nothing
    runs, and the call is noted in an open ``roofline.flops.Tally``.
    """
    if all(t.device.type == "meta" for t in (q, k, v)):
        from repro_torch.roofline.flops import note_kernel_call

        out = torch.empty_like(q)
        note_kernel_call("flash_attention", (q, k, v), out)
        return out
    if q.device.type == "cuda":
        _require_kernel_block_k(block_k)
        return flash_attention_bhsd_kernel(q, k, v, causal=causal,
                                           variant=variant)
    _require_cpu(q, k, v)
    return flash_attention_bhsd_plain(q, k, v, causal=causal, variant=variant,
                                      block_q=block_q, block_k=block_k)
