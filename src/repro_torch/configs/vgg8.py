"""VGG-8 (paper section 5.3 architecture evaluation)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="vgg8", family="cnn",
    n_layers=8, d_model=0, n_heads=0, kv_heads=0, head_dim=0, d_ff=0,
    vocab=10, param_dtype="float32", compute_dtype="float32",
)
