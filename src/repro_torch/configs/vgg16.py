"""VGG-16 variation D with 2 FC layers (paper section 5.1.1), CIFAR10."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="vgg16", family="cnn",
    n_layers=16, d_model=0, n_heads=0, kv_heads=0, head_dim=0, d_ff=0,
    vocab=10, param_dtype="float32", compute_dtype="float32",
)
