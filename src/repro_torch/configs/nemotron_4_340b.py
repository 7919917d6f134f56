"""Nemotron-4-340B [arXiv:2402.16819]: GQA kv=8, squared-ReLU MLP."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, act="relu2", norm="layernorm",
    rope_theta=10000.0,
)
