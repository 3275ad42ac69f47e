"""The paper's own workload: the tiled L3 BLAS engine at pod scale.
Not an LM — used by the BLAS dry-run/benchmark paths."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="blasx-gemm",
    family="dense",
    n_layers=0, d_model=16384, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=0,
)
