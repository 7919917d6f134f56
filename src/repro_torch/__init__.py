"""DAISM in PyTorch for one NVIDIA H100.

A module-for-module port of the JAX package ``repro``: the approximate
multiplier numerics (``core``), the hand-written CUDA GEMM kernel
(``kernels``, sources in ``csrc``), per-site approximation policies
(``policy``), the decoder LM (``models``), and the paged continuous-batching
engine (``serve``). Spec strings, site paths and parameter key names are the
same as the JAX package's, so one ``--policy`` string and one parameter tree
mean the same thing in both.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
