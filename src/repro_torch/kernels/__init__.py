"""Hand-written Hopper kernels for DAISM's compute hot spots.

csrc/daism_matmul.cu - approximate GEMM (replaces the Pallas daism_matmul)
daism_matmul.py      - ctypes binding, launch counter, plain version
approx_product.py    - plain-torch twin of csrc/approx_product.cuh
build.py             - nvcc build of csrc/ at first use, cached by hash
ops.py               - public wrapper (device dispatch)
ref.py               - plain-torch oracle the kernel is validated against
"""
