"""DBRX-132B [hf:databricks/dbrx-base]: MoE 16 experts top-4, GQA kv=8."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, act="swiglu", norm="rmsnorm",
    rope_theta=500000.0,
    n_experts=16, topk=4, expert_ff=10752,
)
