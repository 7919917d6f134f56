"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block.
ssm_state=64; hybrid => runs long_500k (shared attn uses a 4k sliding
window at long context, DESIGN.md section 4)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, act="swiglu", norm="rmsnorm",
    rope_theta=10000.0,
    ssm_state=64, d_inner=4096, ssm_heads=64, conv_kernel=4,
    shared_attn_every=6, window=4096,
)
