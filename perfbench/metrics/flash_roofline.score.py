"""The flash-attention kernel's summed roofline bounds (causal pairs,
``work.py``) over its device time in the profiled segment (%)."""
from perfbench import readers


def read(layer):
    return readers.roofline(layer, "flash_bound_s", readers.FLASH_KERNELS)
