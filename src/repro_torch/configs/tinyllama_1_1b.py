"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch small, GQA kv=4."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32000, act="swiglu", norm="rmsnorm",
    rope_theta=10000.0,
)
