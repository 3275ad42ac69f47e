"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821; hf].
VLM: the InternViT-6B frontend is a stub — input_specs() supplies
precomputed patch embeddings (per assignment)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,          # GQA
    d_ff=16384,
    vocab_size=92553,
    act="silu",
    frontend="vision",
)
