"""The benchmark's own arithmetic: FLOPs and bytes from a configuration's
shapes, and the least time an H100 could take for them.

Counts are of the work a result needs, whatever computes it: a GEMM of
(M, K, N) is 2MKN FLOPs at the bf16 tensor-core peak and reads its bf16
operands once and writes its f32 output once; attention counts the causal
pairs it needs (QK and PV, 2 FLOPs a MAC); padded rows are never work.
Nothing here is read from the program.
"""
from __future__ import annotations

from typing import List, Tuple

PEAK_FLOPS = 989e12     # H100 SXM bf16 dense (NVIDIA data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3

Gemm = Tuple[str, int, int]      # (site, K, N)


def attn_gemms(w: dict, site: str = "attn") -> List[Gemm]:
    d, qd = w["d_model"], w["n_heads"] * w["head_dim"]
    kvd = w["kv_heads"] * w["head_dim"]
    return [(site, d, qd), (site, d, kvd), (site, d, kvd), (site, qd, d)]


def ffn_gemms(w: dict) -> List[Gemm]:
    return [("ffn", w["d_model"], w["d_ff"]), ("ffn", w["d_ff"], w["d_model"])]


def lm_head_gemm(w: dict) -> Gemm:
    return ("lm_head", w["d_model"], w["vocab"])


def decoder_layer_gemms(w: dict) -> List[Gemm]:
    """The projections of one dense decoder layer."""
    return attn_gemms(w) + ffn_gemms(w)


def encdec_decode_gemms(w: dict) -> List[Gemm]:
    """What one decoded token needs of one Whisper decoder layer: self
    q/k/v/o, cross q and o, the MLP. The cross K/V projections of the
    encoder states are set-up, once a clip."""
    d = w["d_model"]
    return (attn_gemms(w) + [("xattn", d, d), ("xattn", d, d)]
            + ffn_gemms(w))


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def gemm_bytes(m: int, k: int, n: int) -> float:
    return 2.0 * (m * k + k * n) + 4.0 * m * n


def gemm_bound_s(m: int, k: int, n: int) -> float:
    """The least time of one (M, K, N) GEMM: compute or memory."""
    if m <= 0:
        return 0.0
    return max(gemm_flops(m, k, n) / PEAK_FLOPS,
               gemm_bytes(m, k, n) / PEAK_BYTES)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def attn_flops(w: dict, pairs: int) -> float:
    """QK and PV over ``pairs`` (query, key) pairs of every head."""
    return 4.0 * w["n_heads"] * w["head_dim"] * pairs


def flash_bound_s(w: dict, b: int, s: int) -> float:
    """The least time of one causal self-attention call of ``b`` rows of
    ``s`` tokens: q, k, v read once, the output written once (bf16)."""
    h, kh, d = w["n_heads"], w["kv_heads"], w["head_dim"]
    flops = b * attn_flops(w, causal_pairs(s))
    byts = 2.0 * (2 * b * s * h * d + 2 * b * s * kh * d)
    return max(flops / PEAK_FLOPS, byts / PEAK_BYTES)


def decoder_flops(w: dict, tokens: int, pairs: int) -> float:
    """Forward FLOPs of ``tokens`` tokens through every layer and the
    lm_head, attending over ``pairs`` causal pairs in all."""
    per_tok = sum(k * n for _, k, n in decoder_layer_gemms(w))
    _, k, n = lm_head_gemm(w)
    return (2.0 * tokens * (w["n_layers"] * per_tok + k * n)
            + w["n_layers"] * attn_flops(w, pairs))


def encdec_decode_flops(w: dict, tokens: int, pairs: int) -> float:
    """FLOPs of ``tokens`` decoded Whisper tokens: the decoder's
    projections but the cross K/V, self attention over ``pairs`` causal
    pairs, cross attention to every encoder frame, and the lm_head."""
    per_tok = sum(k * n for _, k, n in encdec_decode_gemms(w))
    _, k, n = lm_head_gemm(w)
    return (2.0 * tokens * (w["n_layers"] * per_tok + k * n)
            + w["n_layers"] * (attn_flops(w, pairs)
                               + attn_flops(w, tokens * w["enc_frames"])))


def gemm_bound_rows(gemms: List[Gemm], rows: int, sites) -> float:
    """Summed bounds of ``gemms`` at ``rows`` rows, for the sites that run
    the DAISM kernel (``sites``)."""
    return sum(gemm_bound_s(rows, k, n) for s, k, n in gemms if s in sites)
