"""LeNet-5 (paper section 5.1): 2 conv (5x5) + 3 FC, MNIST."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="lenet5", family="cnn",
    n_layers=5, d_model=0, n_heads=0, kv_heads=0, head_dim=0, d_ff=0,
    vocab=10, param_dtype="float32", compute_dtype="float32",
)
