"""Model FLOPs of the traced decode steps over the H100's bf16 peak for as
long as the device ran an operation in them (%): the whole step's share of
the peak, beside ``transcribe_device_tok_s``."""
from perfbench.readers import busy_mfu as read  # noqa: F401
