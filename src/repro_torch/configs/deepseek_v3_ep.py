"""DeepSeek-V3 with its published router and RoPE, as one card's share of
an expert-parallel deployment: a port-only config type.

The registry's ``deepseek_v3_671b`` is the reference's config, held
field for field against it; it runs the reference's softmax top-k
router with capacity drops, plain RoPE and norm eps 1e-5.
:class:`DeepSeekV3Config` is a ``ModelConfig`` that the registry does
not list; the model stack reads the settings below through the
methods it overrides (``rope_inv_freq``, ``mla_softmax_scale``,
``held_experts``), whose ``ModelConfig`` defaults keep every other
config as it was:

* the router of the published config.json (``scoring_func`` sigmoid,
  ``topk_method`` noaux_tc): sigmoid scores over all ``n_experts``; a
  per-expert selection bias added for choosing only; a group's score
  the sum of its two best biased scores; the best ``topk_group`` of
  ``n_group`` groups; the best ``top_k`` experts within them; weights
  the unbiased scores, normalised over the ``top_k``
  (``norm_topk_prob``) and times ``routed_scaling_factor``;
* YaRN RoPE on the rope dims (``rope_factor``, ``rope_original_len``,
  ``beta_fast``, ``beta_slow``) and MLA's softmax scale times
  ``mscale(rope_factor, mscale_all_dim)**2``;
* the experts held here, ``experts_held`` of them from
  ``expert_first``: the layer routes over all ``n_experts`` and computes
  only its held experts' part, dropping nothing.

Multi-token prediction is not served (``mtp`` stays False): serving
without speculative decoding never runs it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import ModelConfig


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor, ``0.1 * mscale * ln(factor) + 1``."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    scoring_func: str = "sigmoid"
    n_group: int = 8
    topk_group: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    # the selection bias is drawn from the seed as N(0, 1) times this
    # (random weights: a trained model learns it)
    selection_bias_std: float = 0.1
    rope_factor: float = 40.0
    rope_original_len: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 1.0
    expert_first: int = 0
    experts_held: int = 8

    def __post_init__(self):
        if self.scoring_func != "sigmoid":
            raise ValueError(f"scoring_func {self.scoring_func!r}: only "
                             f"the published 'sigmoid' is implemented")
        if self.mtp:
            raise ValueError("multi-token prediction is not served")
        if self.n_experts % self.n_group or self.topk_group > self.n_group:
            raise ValueError(f"{self.n_experts} experts in {self.n_group} "
                             f"groups, {self.topk_group} kept")
        if not 0 <= self.expert_first <= (self.n_experts
                                          - self.experts_held):
            raise ValueError(f"experts {self.expert_first}.."
                             f"{self.expert_first + self.experts_held - 1} "
                             f"of {self.n_experts}")

    @classmethod
    def from_hf(cls, hf: dict, **fields) -> "DeepSeekV3Config":
        """The config from a DeepSeek-V3 ``config.json``'s keys, where
        ``n_routed_experts`` counts the experts held here, from
        ``first_held_expert``, of the ``experts_routed_over`` the router
        chooses among; ``fields`` set the rest (``dtype``, ``name``)."""
        rope = hf["rope_scaling"]
        if rope.get("type") != "yarn" or hf["topk_method"] != "noaux_tc":
            raise ValueError("only YaRN RoPE and the noaux_tc router")
        if rope["mscale"] != rope["mscale_all_dim"]:
            raise ValueError("YaRN with mscale != mscale_all_dim scales "
                             "cos and sin too; not implemented")
        kw = dict(
            name="deepseek-v3", family="moe",
            n_layers=hf["num_hidden_layers"], d_model=hf["hidden_size"],
            n_heads=hf["num_attention_heads"],
            n_kv_heads=hf["num_key_value_heads"],
            d_ff=hf["intermediate_size"], vocab_size=hf["vocab_size"],
            n_experts=hf["experts_routed_over"],
            top_k=hf["num_experts_per_tok"],
            moe_d_ff=hf["moe_intermediate_size"],
            n_shared_experts=hf["n_shared_experts"],
            n_dense_layers=hf["first_k_dense_replace"],
            use_mla=True, q_lora_rank=hf["q_lora_rank"],
            kv_lora_rank=hf["kv_lora_rank"],
            qk_nope_head_dim=hf["qk_nope_head_dim"],
            qk_rope_head_dim=hf["qk_rope_head_dim"],
            v_head_dim=hf["v_head_dim"],
            mtp=hf["num_nextn_predict_layers"] > 0, act=hf["hidden_act"],
            rope_theta=float(hf["rope_theta"]),
            tie_embeddings=hf["tie_word_embeddings"],
            norm_eps=hf["rms_norm_eps"], remat=False,
            scoring_func=hf["scoring_func"], n_group=hf["n_group"],
            topk_group=hf["topk_group"], norm_topk_prob=hf["norm_topk_prob"],
            routed_scaling_factor=float(hf["routed_scaling_factor"]),
            rope_factor=float(rope["factor"]),
            rope_original_len=rope["original_max_position_embeddings"],
            beta_fast=float(rope["beta_fast"]),
            beta_slow=float(rope["beta_slow"]),
            mscale_all_dim=float(rope["mscale_all_dim"]),
            expert_first=hf["first_held_expert"],
            experts_held=hf["n_routed_experts"])
        kw.update(fields)
        return cls(**kw)

    def rope_inv_freq(self, dim: int, dtype=torch.float32, device=None
                      ) -> torch.Tensor:
        """YaRN's frequencies of ``dim`` rope dims: each base frequency
        ``theta**(-2i/dim)`` kept where a dim turns more than
        ``beta_fast`` times over the original context, divided by
        ``rope_factor`` where it turns fewer than ``beta_slow`` times,
        and blended linearly between."""
        theta = self.rope_theta

        def at(turns):
            return dim * math.log(self.rope_original_len
                                  / (turns * 2 * math.pi)) / (
                2 * math.log(theta))
        low = max(math.floor(at(self.beta_fast)), 0)
        high = min(math.ceil(at(self.beta_slow)), dim - 1)
        if low == high:
            high += 0.001
        i = torch.arange(dim // 2, dtype=dtype, device=device)
        interp = ((i - low) / (high - low)).clamp(0, 1)
        base = 1.0 / theta ** (2 * i / dim)
        return base / self.rope_factor * interp + base * (1 - interp)

    def mla_softmax_scale(self) -> float:
        """MLA's ``(nope + rope)**-0.5`` times YaRN's factor squared."""
        m = yarn_mscale(self.rope_factor, self.mscale_all_dim)
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 * m * m

    def held_experts(self) -> range:
        return range(self.expert_first, self.expert_first + self.experts_held)
