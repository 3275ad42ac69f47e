"""repro_torch — the BLASX reproduction ported to PyTorch and CUDA.

It mirrors the JAX package ``repro`` module for module (``core``,
``backends``, ``kernels``, ``api``) and is held against it: the same
inputs give results within the reference's tolerances and, for the
same ``RuntimeConfig``, identical ledgers.  Entry points compute on the
card unless the caller passes ``device="cpu"``.  The Pallas TPU matmul
became a hand-written CUDA kernel (``repro_torch.kernels``), built with
``nvcc`` at first use.
"""
