"""Gemma-2B [arXiv:2403.08295]: GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", norm="rmsnorm",
    rope_theta=10000.0, tie_embeddings=True,
)
