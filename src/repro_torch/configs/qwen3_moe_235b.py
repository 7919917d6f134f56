"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128 experts top-8."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, act="swiglu", norm="rmsnorm",
    rope_theta=1000000.0,
    n_experts=128, topk=8, expert_ff=1536,
)
