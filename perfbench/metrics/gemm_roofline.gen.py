"""The DAISM GEMM kernels' summed roofline bounds (`work.py`, useful rows
only) over their device time in the profiled segment (%)."""
from perfbench import readers


def read(layer):
    return readers.roofline(layer, "gemm_bound_s", readers.GEMM_KERNELS)
