"""StarCoder2-15B [arXiv:2402.19173]: GQA kv=4, RoPE, LayerNorm."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, act="gelu", norm="layernorm",
    rope_theta=100000.0,
)
