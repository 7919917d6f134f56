"""Model FLOPs of the window over the H100's bf16 peak for as long (%)."""
from perfbench.readers import mfu as read  # noqa: F401
