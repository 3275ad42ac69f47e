"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf] — qk_norm, GQA, head_dim=128."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,          # GQA
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,          # decoupled from d_model/n_heads in qwen3
    qk_norm=True,
    act="silu",
    tie_embeddings=True,
)
