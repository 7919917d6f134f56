"""The DAISM GEMM's least time over its device time in the traced decode
steps (%)."""
from perfbench import readers


def read(layer):
    return readers.roofline(layer, "gemm_bound_s", readers.GEMM_KERNELS)
