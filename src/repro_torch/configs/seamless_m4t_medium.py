"""SeamlessM4T-medium [arXiv:2308.11596; hf] — encoder-decoder backbone.
Audio: the speech frontend (w2v-BERT conformer) is a stub — input_specs()
supplies precomputed frame embeddings (per assignment)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,           # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    act="gelu",
    frontend="audio",
)
