"""OLMo-1B [arXiv:2402.00838; hf] — non-parametric LayerNorm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA (GQA kv=16)
    d_ff=8192,
    vocab_size=50304,
    nonparametric_ln=True,
    act="silu",
)
