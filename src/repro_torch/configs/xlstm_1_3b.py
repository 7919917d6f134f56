"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM blocks (xLSTM[7:1]),
attention-free => runs long_500k."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304, act="gelu", norm="rmsnorm",
    rope_theta=0.0,
    slstm_every=8,
)
