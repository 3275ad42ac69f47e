"""Model assembly, dense family.

The counterpart of the reference's ``models/transformer.py`` for its
dense family (GQA attention + MLP blocks, e.g. Qwen3, GLM-4, OLMo).
Layers are *stacked* (leading L dim, as in the reference's parameter
tree) and driven by a Python loop over L in place of ``lax.scan``.
The moe, ssm, hybrid and encdec families and MLA raise
``NotImplementedError``: they come with ROADMAP Queue 1 item 11.

``Model`` exposes:
  init(seed)           real parameters, on the model's device
  train_logits(...)    full-sequence logits
  prefill(...)         logits of last position + serving cache
  decode(...)          one-token step with cache

Caches are ``{"blocks": {"k": (L, B, S, Hkv, hd), "v": ...}}``, the
sequence on axis 2 as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .attention import gqa_attention, make_attn_params
from .layers import Maker, apply_norm, make_mlp_params, mlp
from .sharding import MeshRules, NO_MESH

_NOT_PORTED = "it comes with the slice of the other model families"


class _Stacked:
    """Maker proxy that prepends the layer dimension to every param."""

    def __init__(self, base: Maker, n: int):
        self._base = base
        self._n = n

    def param(self, shape, logical, **kw):
        return self._base.param((self._n,) + tuple(shape),
                                (None,) + tuple(logical), **kw)

    def ones(self, shape, logical, **kw):
        return self._base.ones((self._n,) + tuple(shape),
                               (None,) + tuple(logical), **kw)


def _dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_ported(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({_NOT_PORTED})")
    if cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet ({_NOT_PORTED})")


# ==========================================================================
# parameter construction
# ==========================================================================
def _attn_block_params(mk, cfg) -> dict:
    p: Dict[str, Any] = {}
    if not cfg.nonparametric_ln:
        p["ln1"] = mk.ones((cfg.d_model,), (None,))
        p["ln2"] = mk.ones((cfg.d_model,), (None,))
    p["attn"] = make_attn_params(mk, cfg)
    p["mlp"] = make_mlp_params(mk, cfg.d_model, cfg.d_ff)
    return p


def build_params(cfg, mode: str, rules: MeshRules,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> dict:
    _check_ported(cfg)
    mk = Maker(mode, rules, _dtype_of(cfg), generator, device)
    p: Dict[str, Any] = {
        "embed": mk.param((cfg.vocab_size, cfg.d_model), ("model", "embed"),
                          scale=0.02),
        "final_norm": mk.ones((cfg.d_model,), (None,)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = mk.param((cfg.d_model, cfg.vocab_size),
                                ("embed", "model"))
    p["blocks"] = _attn_block_params(_Stacked(mk, cfg.n_layers), cfg)
    return p


# ==========================================================================
# block applications
# ==========================================================================
def _attn_block(cfg, rules, p, x, positions, *, cache=None, cache_index=None,
                make_cache=False):
    h = apply_norm(cfg, x, p.get("ln1"))
    a, new_cache = gqa_attention(cfg, p["attn"], h, positions, rules,
                                 cache=cache, cache_index=cache_index,
                                 make_cache=make_cache)
    x = x + a
    h = apply_norm(cfg, x, p.get("ln2"))
    x = x + mlp(cfg, p["mlp"], h, rules)
    x = rules.constrain(x, "batch", "seq", None)
    return x, new_cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (leading-L) parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _scan_blocks(cfg, rules, stacked, x, positions, *, caches=None,
                 cache_index=None, make_cache=False):
    """Run a stacked group layer by layer.  Returns (x, caches): with
    ``make_cache`` the per-layer caches stacked on a new leading L axis;
    with ``caches`` the same (updated in place) caches."""
    n = next(iter(stacked["attn"].values())).shape[0]
    made = []
    for i in range(n):
        lcache = _layer(caches, i) if caches is not None else None
        x, ncache = _attn_block(cfg, rules, _layer(stacked, i), x, positions,
                                cache=lcache, cache_index=cache_index,
                                make_cache=make_cache)
        if make_cache:
            made.append(ncache)
    if make_cache:
        return x, {k: torch.stack([c[k] for c in made]) for k in made[0]}
    return x, caches


# ==========================================================================
# the Model facade
# ==========================================================================
@dataclasses.dataclass
class Model:
    cfg: Any
    rules: MeshRules = NO_MESH

    # ------------------------------------------------------------ params
    def init(self, seed: int = 0, device="cuda") -> dict:
        """Parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (the card unless the caller asks for the
        CPU).  The numbers differ from the reference's ``jax.random``
        ones; ``models.convert.params_from_reference`` carries the
        reference's tree over instead."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return build_params(self.cfg, "init", self.rules, gen, device)

    # ------------------------------------------------------------ head
    def head_matrix(self, params) -> torch.Tensor:
        """(d_model, vocab) unembedding matrix."""
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _logits(self, params, x):
        """float32 logits: the reference's dot with
        preferred_element_type=f32, i.e. products of the stored values
        summed in f32 (not a bf16 result widened afterwards)."""
        x = apply_norm(self.cfg, x, params["final_norm"])
        head = self.head_matrix(params).to(x.dtype)
        logits = torch.matmul(x.float(), head.float())
        return self.rules.constrain(logits, "batch", "seq", "model")

    # ----------------------------------------------------------- forward
    def train_logits(self, params, *, tokens) -> Tuple[torch.Tensor, dict]:
        """Full-sequence logits.  Returns (logits, aux)."""
        cfg, rules = self.cfg, self.rules
        _check_ported(cfg)
        x = params["embed"][tokens]
        x = rules.constrain(x, "batch", "seq", None)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, _ = _scan_blocks(cfg, rules, params["blocks"], x, pos)
        return self._logits(params, x), {}

    # ----------------------------------------------------------- serving
    @staticmethod
    def pad_cache(cache: dict, pad_to: int) -> dict:
        """Grow prompt-sized KV caches to the serving max length (the
        sequence axis is axis 2 of the k/v leaves)."""
        def pad(name, leaf):
            if isinstance(leaf, dict):
                return {k: pad(k, v) for k, v in leaf.items()}
            if name in ("k", "v") and leaf.shape[2] < pad_to:
                extra = list(leaf.shape)
                extra[2] = pad_to - leaf.shape[2]
                return torch.cat([leaf, leaf.new_zeros(extra)], dim=2)
            return leaf
        return pad(None, cache)

    def prefill(self, params, *, tokens) -> Tuple[torch.Tensor, dict]:
        """Process the prompt; return (last-position logits, cache)."""
        cfg, rules = self.cfg, self.rules
        _check_ported(cfg)
        x = params["embed"][tokens]
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, kv = _scan_blocks(cfg, rules, params["blocks"], x, pos,
                             make_cache=True)
        return self._logits(params, x[:, -1:, :]), {"blocks": kv}

    def decode(self, params, cache: dict, token: torch.Tensor,
               pos_index: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step.  token: (B,) int; pos_index: (B,) int (number
        of tokens already in the cache).  The cache is updated in place
        and returned."""
        cfg, rules = self.cfg, self.rules
        _check_ported(cfg)
        x = params["embed"][token[:, None]]
        positions = pos_index[:, None]
        x, kv = _scan_blocks(cfg, rules, params["blocks"], x, positions,
                             caches=cache["blocks"], cache_index=pos_index)
        logits = self._logits(params, x)
        return logits[:, 0, :], {"blocks": kv}
