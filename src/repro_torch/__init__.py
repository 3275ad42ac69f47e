"""repro_torch — the BLASX reproduction ported to PyTorch and CUDA.

It mirrors the JAX package ``repro`` module for module (``core``,
``backends``, ``kernels``, ``api``, ``configs``, ``models``, ``launch``)
and is held against it: the same inputs give results within the
reference's tolerances and, for the same ``RuntimeConfig``, identical
ledgers.  Entry points compute on the card unless the caller passes
``device="cpu"``.  The Pallas TPU kernels became hand-written CUDA
kernels (``repro_torch.kernels``: the tile GEMM with its bias/activation
epilogue, and flash attention), built with ``nvcc`` at first use.
"""
