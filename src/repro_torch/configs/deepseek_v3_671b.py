"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed
top-8 MoE, MTP head, 3 leading dense layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,        # per assignment; attention is MLA below
    d_ff=18432,            # dense-layer FFN width
    vocab_size=129280,
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,         # per assignment: d_ff=2048 per expert
    n_shared_experts=1,
    n_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp=True,
    act="silu",
)
