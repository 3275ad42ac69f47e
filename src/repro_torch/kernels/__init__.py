"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``), their wrappers (``matmul``, ``ops``) and their build
(``build``).  Importing this package builds and launches nothing."""
