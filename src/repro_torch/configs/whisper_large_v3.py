"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec, conv/audio frontend is a
stub (precomputed frame embeddings). 32 enc + 32 dec layers, MHA (kv=20)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, act="gelu", norm="layernorm",
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions
    enc_layers=32, enc_frames=1500,
)
