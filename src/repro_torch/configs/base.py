"""Model/runtime configuration system.

One dataclass covers the five assigned families (dense / moe / ssm /
hybrid / encdec).  Each architecture file exports ``CONFIG`` (the exact
published dims) and the registry maps ``--arch <id>`` to it.  Every
config can produce a ``reduced()`` variant for CPU smoke tests.

The port's own copy of the reference's ``configs/base.py`` (the port
imports nothing of the reference package); the architecture files
beside it are copies too, so both registries hold the same configs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width
    n_shared_experts: int = 0
    n_dense_layers: int = 0           # leading dense layers (deepseek)
    capacity_factor: float = 1.25

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False                 # multi-token-prediction extra head

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0               # hybrid: shared attn block period
    shared_attn: bool = False         # zamba2: reuse one attn block

    # --- enc-dec ---
    n_encoder_layers: int = 0

    # --- misc ---
    qk_norm: bool = False
    nonparametric_ln: bool = False    # olmo: LN without affine params
    act: str = "silu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    frontend: Optional[str] = None    # None | 'vision' | 'audio' (stubs)
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: bool = True                # activation checkpoint per block

    # ------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:         # mamba2 expansion
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts?  (SSM state is O(1);
        hybrids pay only for the sparse shared-attention blocks.)"""
        return self.family in ("ssm", "hybrid")

    # -------------------------------------- settings a subclass overrides
    # (methods, not fields: the registry's configs hold the reference's
    # fields alone)
    def mla_softmax_scale(self) -> float:
        """MLA's softmax scale, prefill and absorbed decode alike."""
        return 1.0 / math.sqrt(self.qk_nope_head_dim + self.qk_rope_head_dim)

    def rope_inv_freq(self, dim: int, dtype=None, device=None):
        """The frequencies of ``dim`` rotated dims, (dim//2,); None: the
        plain ``rope_theta**(-2i/dim)`` that ``rope_angles`` computes."""
        return None

    def held_experts(self) -> Optional[range]:
        """The experts a MoE layer holds and computes of the ``n_experts``
        it routes over, dropping nothing; None: every expert, under the
        reference's softmax top-k router and capacity."""
        return None

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.use_mla:
            qh = self.qk_nope_head_dim + self.qk_rope_head_dim
            attn = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qh
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    + self.kv_lora_rank * self.n_heads *
                    (self.qk_nope_head_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        mlp_dense = 3 * d * ff
        total = 0
        if self.family in ("dense", "encdec"):
            n = self.n_layers + self.n_encoder_layers
            total = n * (attn + mlp_dense)
        elif self.family == "moe":
            moe = (d * self.n_experts
                   + self.n_experts * 3 * d * self.moe_d_ff
                   + self.n_shared_experts * 3 * d * self.moe_d_ff)
            total = (self.n_dense_layers * (attn + mlp_dense)
                     + (self.n_layers - self.n_dense_layers) * (attn + moe))
        elif self.family == "ssm":
            di, ds, H = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * ds
            mamba = (d * (2 * di + 2 * ds + H) + self.ssm_conv * conv_dim
                     + 3 * H + di + di * d)
            total = self.n_layers * mamba
        elif self.family == "hybrid":
            di, ds, H = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * ds
            mamba = (d * (2 * di + 2 * ds + H) + self.ssm_conv * conv_dim
                     + 3 * H + di + di * d)
            n_attn_apps = self.n_layers // max(1, self.attn_every)
            n_attn_blocks = 1 if self.shared_attn else n_attn_apps
            total = (self.n_layers * mamba
                     + n_attn_blocks * (attn + mlp_dense))
        total += V * d * (1 if self.tie_embeddings else 2)
        if self.mtp:
            total += attn + mlp_dense
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full_moe = self.n_experts * 3 * d * self.moe_d_ff
        act_moe = self.top_k * 3 * d * self.moe_d_ff
        n_moe_layers = self.n_layers - self.n_dense_layers
        return self.param_count() - n_moe_layers * (full_moe - act_moe)

    # ----------------------------------------------------------- reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        hd = 8
        kw.update(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid"
                         else max(2, self.attn_every)),
            d_model=64, d_ff=128, vocab_size=256,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=hd, remat=False, dtype="float32",
        )
        if self.family == "moe":
            # capacity_factor = E/K: no token drops, so smoke tests can
            # check train/prefill/decode logit consistency exactly
            kw.update(n_experts=4, top_k=2, moe_d_ff=32,
                      n_dense_layers=min(self.n_dense_layers, 1),
                      n_layers=2 + min(self.n_dense_layers, 1),
                      capacity_factor=2.0)
        if self.use_mla:
            kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=hd,
                      qk_rope_head_dim=hd // 2, v_head_dim=hd)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        if self.family == "hybrid":
            kw.update(n_layers=4, attn_every=2)
        if self.family == "encdec":
            kw.update(n_encoder_layers=2)
        kw["name"] = self.name + "-smoke"
        return ModelConfig(**kw)


# --------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch x shape) runnable?  (long_500k needs sub-quadratic paths;
    pure full-attention archs skip it — recorded, per the assignment.)"""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: no sub-quadratic path for "
                       "524288-token decode (skip per assignment)")
    return True, ""
