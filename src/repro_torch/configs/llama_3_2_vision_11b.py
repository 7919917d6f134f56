"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision]: cross-attn
image layers every 5 blocks; vision frontend is a stub (precomputed patch
embeddings via input_specs, per the assignment)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, act="swiglu", norm="rmsnorm",
    rope_theta=500000.0,
    cross_every=5, n_image_tokens=1601,
)
