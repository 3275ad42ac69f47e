"""Model assembly for the five families (dense / moe / ssm / hybrid /
encdec).

The counterpart of the reference's ``models/transformer.py``.  Layers
are *stacked* (leading L dim, as in the reference's parameter tree) and
driven by a Python loop over L in place of ``lax.scan``.
Heterogeneous stacks (DeepSeek's dense then MoE layers; Zamba2's shared
attention block every ``attn_every`` Mamba layers) are segments of such
loops.

``Model`` exposes:
  init(seed)           real parameters, on the model's device
  train_logits(...)    full-sequence logits (+ aux losses)
  prefill(...)         logits of last position + serving cache
  decode(...)          one-token step with cache

Caches hold the sequence on axis 2 of their k/v/ckv/k_rope leaves, as
in the reference: ``{"blocks": {"k": (L, B, S, Hkv, hd), "v": ...}}``
(dense), ``{"dense_blocks": ..., "moe_blocks": ...}`` (moe; MLA leaves
``ckv`` / ``k_rope``), ``{"blocks": {"conv", "ssm"}}`` (ssm),
``{"mamba": ..., "attn": ...}`` (hybrid) and ``{"dec_blocks": {"k",
"v", "cross_k", "cross_v"}}`` (encdec).  Decode updates a cache in
place and returns it.  The reference's ``abstract`` parameters and
``abstract_cache`` (shapes with shardings, for the dry-run) come with
the dry-run's port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..tree import tree_map
from .attention import gqa_attention, make_attn_params, make_mla_params, \
    mla_attention
from .layers import Maker, apply_norm, make_mlp_params, mlp
from .moe import make_moe_params, moe_block
from .sharding import MeshRules, NO_MESH
from .ssm import make_mamba_params, mamba_block


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


# ==========================================================================
# parameter construction
# ==========================================================================
def _attn_block_params(mk, cfg, ff: Optional[int] = None,
                       moe: bool = False, cross: bool = False) -> dict:
    p: Dict[str, Any] = {}
    if not cfg.nonparametric_ln:
        p["ln1"] = mk.ones((cfg.d_model,), (None,))
        p["ln2"] = mk.ones((cfg.d_model,), (None,))
    p["attn"] = (make_mla_params(mk, cfg) if cfg.use_mla
                 else make_attn_params(mk, cfg))
    if cross:
        if not cfg.nonparametric_ln:
            p["ln_cross"] = mk.ones((cfg.d_model,), (None,))
        p["cross"] = make_attn_params(mk, cfg)
    if moe:
        p["moe"] = make_moe_params(mk, cfg)
    else:
        p["mlp"] = make_mlp_params(mk, cfg.d_model, ff or cfg.d_ff)
    return p


def _mamba_block_params(mk, cfg) -> dict:
    return {
        "ln": mk.ones((cfg.d_model,), (None,)),
        "mixer": make_mamba_params(mk, cfg),
    }


def build_params(cfg, mode: str, rules: MeshRules,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> dict:
    mk = Maker(mode, rules, _dtype_of(cfg), generator, device)
    p: Dict[str, Any] = {
        "embed": mk.param((cfg.vocab_size, cfg.d_model), ("model", "embed"),
                          scale=0.02),
        "final_norm": mk.ones((cfg.d_model,), (None,)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = mk.param((cfg.d_model, cfg.vocab_size),
                                ("embed", "model"))

    fam = cfg.family
    if fam == "dense":
        p["blocks"] = _attn_block_params(_Stacked(mk, cfg.n_layers), cfg)
    elif fam == "moe":
        nd = cfg.n_dense_layers
        if nd:
            p["dense_blocks"] = _attn_block_params(_Stacked(mk, nd), cfg)
        p["moe_blocks"] = _attn_block_params(
            _Stacked(mk, cfg.n_layers - nd), cfg, moe=True)
        if cfg.mtp:
            p["mtp_block"] = _attn_block_params(mk, cfg)
            p["mtp_norm"] = mk.ones((cfg.d_model,), (None,))
    elif fam == "ssm":
        p["blocks"] = _mamba_block_params(_Stacked(mk, cfg.n_layers), cfg)
    elif fam == "hybrid":
        p["blocks"] = _mamba_block_params(_Stacked(mk, cfg.n_layers), cfg)
        p["shared_attn"] = _attn_block_params(mk, cfg)  # ONE shared block
    elif fam == "encdec":
        p["enc_blocks"] = _attn_block_params(
            _Stacked(mk, cfg.n_encoder_layers), cfg)
        p["dec_blocks"] = _attn_block_params(
            _Stacked(mk, cfg.n_layers), cfg, cross=True)
        p["enc_norm"] = mk.ones((cfg.d_model,), (None,))
    else:
        raise ValueError(f"unknown family {fam}")
    return p


# ==========================================================================
# block applications
# ==========================================================================
def _attn_block(cfg, rules, p, x, positions, *, cache=None, cache_index=None,
                make_cache=False, causal=True, enc_out=None, q_chunk=1024):
    h = apply_norm(cfg, x, p.get("ln1"))
    if cfg.use_mla:
        a, new_cache = mla_attention(cfg, p["attn"], h, positions, rules,
                                     cache=cache, cache_index=cache_index,
                                     make_cache=make_cache, q_chunk=q_chunk)
    else:
        a, new_cache = gqa_attention(cfg, p["attn"], h, positions, rules,
                                     cache=cache, cache_index=cache_index,
                                     make_cache=make_cache, causal=causal,
                                     q_chunk=q_chunk)
    x = x + a
    aux = {}
    if "cross" in p:
        h = apply_norm(cfg, x, p.get("ln_cross"))
        if enc_out is not None:  # train / prefill: project encoder K,V
            c, cross_cache = gqa_attention(
                cfg, p["cross"], h, positions, rules,
                make_cache=make_cache, causal=False, kv_input=enc_out)
            if make_cache:
                new_cache = dict(new_cache or {})
                new_cache["cross_k"] = cross_cache["k"]
                new_cache["cross_v"] = cross_cache["v"]
        else:  # decode: K,V were projected once at prefill
            cc = {"k": cache["cross_k"], "v": cache["cross_v"]}
            c, _ = gqa_attention(
                cfg, p["cross"], h, positions, rules, cache=cc,
                causal=False, kv_input=h)  # kv_input= sentinel: use cache
        x = x + c
    h = apply_norm(cfg, x, p.get("ln2"))
    if "moe" in p:
        m, aux = moe_block(cfg, p["moe"], h, rules)
    else:
        m = mlp(cfg, p["mlp"], h, rules)
    x = x + m
    x = rules.constrain(x, "batch", "seq", None)
    return x, new_cache, aux


def _mamba_block_apply(cfg, rules, p, x, *, state=None, make_state=False):
    h = apply_norm(cfg, x, p.get("ln"))
    y, new_state = mamba_block(cfg, p["mixer"], h, rules, state=state,
                               make_state=make_state)
    x = x + y
    x = rules.constrain(x, "batch", "seq", None)
    return x, new_state


def _layers(tree, lo: int, hi: int):
    """Layers ``lo:hi`` of a stacked (leading-L) tree: views, so writes
    into them land in ``tree``."""
    return tree_map(lambda a: a[lo:hi], tree)


def _stack(parts, join=torch.stack):
    """Per-layer (or per-segment) trees joined leaf by leaf."""
    return tree_map(lambda *xs: join(xs), *parts)


def _scan_blocks(cfg, rules, stacked, x, positions, *, kind,
                 caches=None, cache_index=None, make_cache=False,
                 causal=True, enc_out=None, remat=False, q_chunk=1024):
    """Run a homogeneous stacked group layer by layer.  Returns
    (x, caches, aux): with ``make_cache`` the per-layer caches stacked on
    a new leading L axis; with ``caches`` the same caches, updated in
    place; ``aux`` the MoE layers' aux loss and drop fraction summed
    (empty for a group without MoE layers).  With ``remat`` and grad
    mode on, each layer keeps only its input for the backward pass and
    recomputes the rest there (the reference's ``jax.checkpoint``)."""
    def block(x, lp, lcache):
        if kind == "attn":
            return _attn_block(
                cfg, rules, lp, x, positions, cache=lcache,
                cache_index=cache_index, make_cache=make_cache,
                causal=causal, enc_out=enc_out, q_chunk=q_chunk)
        x, ncache = _mamba_block_apply(cfg, rules, lp, x, state=lcache,
                                       make_state=make_cache)
        return x, ncache, {}

    if remat and torch.is_grad_enabled():
        plain = block

        def block(x, lp, lcache):
            return torch.utils.checkpoint.checkpoint(
                plain, x, lp, lcache, use_reentrant=False)

    n = next(iter(stacked["attn" if kind == "attn" else "mixer"].values())
             ).shape[0]
    made, aux_sum = [], None
    for i in range(n):
        lp = tree_map(lambda a: a[i], stacked)
        lcache = (tree_map(lambda a: a[i], caches)
                  if caches is not None else None)
        x, ncache, aux = block(x, lp, lcache)
        if aux:  # a MoE layer
            vec = torch.stack([aux["moe_aux_loss"], aux["moe_drop_frac"]])
            aux_sum = vec if aux_sum is None else aux_sum + vec
        if make_cache:
            made.append(ncache)
    out_caches = _stack(made) if make_cache else caches
    aux = ({} if aux_sum is None else
           {"moe_aux_loss": aux_sum[0], "moe_drop_frac": aux_sum[1]})
    return x, out_caches, aux


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

    # ------------------------------------------------------------ embed
    def _embed(self, params, tokens=None, embeds=None):
        if embeds is not None:
            return embeds.to(_dtype_of(self.cfg))
        return params["embed"][tokens]

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

    def _encode(self, params, enc_embeds, remat=False):
        cfg, rules = self.cfg, self.rules
        x = enc_embeds.to(_dtype_of(cfg))
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, _, _ = _scan_blocks(cfg, rules, params["enc_blocks"], x, pos,
                               kind="attn", causal=False, remat=remat)
        return apply_norm(cfg, x, params["enc_norm"])

    # ----------------------------------------------------------- forward
    def train_logits(self, params, *, tokens=None, embeds=None,
                     enc_embeds=None, return_hidden: bool = False
                     ) -> Tuple[torch.Tensor, dict]:
        """Full-sequence logits.  Returns (logits, aux); with
        ``return_hidden`` returns the final-norm hidden states instead
        (aux carries ``mtp_hidden``), so the caller can compute a chunked
        cross-entropy without materializing (B, S, V) logits."""
        cfg, rules = self.cfg, self.rules
        x = self._embed(params, tokens, embeds)
        x = rules.constrain(x, "batch", "seq", None)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        remat = cfg.remat
        aux: Dict[str, torch.Tensor] = {}

        if cfg.family == "dense":
            x, _, _ = _scan_blocks(cfg, rules, params["blocks"], x, pos,
                                   kind="attn", remat=remat)
        elif cfg.family == "moe":
            if cfg.n_dense_layers:
                x, _, _ = _scan_blocks(cfg, rules, params["dense_blocks"], x,
                                       pos, kind="attn", remat=remat)
            x, _, aux = _scan_blocks(cfg, rules, params["moe_blocks"], x, pos,
                                     kind="attn", remat=remat)
            if cfg.mtp:
                xm, _, _ = _attn_block(cfg, rules, params["mtp_block"],
                                       apply_norm(cfg, x, params["mtp_norm"]),
                                       pos)
                aux["mtp_hidden"] = xm
        elif cfg.family == "ssm":
            x, _, _ = _scan_blocks(cfg, rules, params["blocks"], x, pos,
                                   kind="mamba", remat=remat)
        elif cfg.family == "hybrid":
            x, _ = self._hybrid_stack(params, x, pos, remat=remat)
        elif cfg.family == "encdec":
            enc = self._encode(params, enc_embeds, remat)
            x, _, _ = _scan_blocks(cfg, rules, params["dec_blocks"], x, pos,
                                   kind="attn", enc_out=enc, remat=remat)
        if return_hidden:
            xh = apply_norm(cfg, x, params["final_norm"])
            if "mtp_hidden" in aux:
                aux["mtp_hidden"] = apply_norm(cfg, aux["mtp_hidden"],
                                               params["final_norm"])
            return xh, aux
        logits = self._logits(params, x)
        if "mtp_hidden" in aux:
            aux["mtp_logits"] = self._logits(params, aux.pop("mtp_hidden"))
        return logits, aux

    def _hybrid_stack(self, params, x, pos, *, caches=None,
                      cache_index=None, make_cache=False, remat=False):
        """Zamba2: segments of ``attn_every`` Mamba layers, each followed
        by THE shared attention block (weights reused; caches distinct).
        Returns (x, cache): with ``make_cache`` the Mamba states
        concatenated over the layers and the shared block's K/V stacked
        over its applications; with ``caches`` the same caches, updated
        in place."""
        cfg, rules = self.cfg, self.rules
        period = cfg.attn_every
        n_seg = cfg.n_layers // period
        bounds = [(s * period, (s + 1) * period) for s in range(n_seg)]
        if cfg.n_layers > n_seg * period:
            bounds.append((n_seg * period, cfg.n_layers))
        new_mamba, new_attn = [], []
        for s, (lo, hi) in enumerate(bounds):
            seg_cache = (_layers(caches["mamba"], lo, hi)
                         if caches is not None else None)
            x, nm, _ = _scan_blocks(cfg, rules,
                                    _layers(params["blocks"], lo, hi), x,
                                    pos, kind="mamba", caches=seg_cache,
                                    make_cache=make_cache,
                                    cache_index=cache_index, remat=remat)
            new_mamba.append(nm)
            if s == n_seg:  # the remainder: no shared block after it
                break
            a_cache = (tree_map(lambda a: a[s], caches["attn"])
                       if caches is not None else None)
            x, na, _ = _attn_block(cfg, rules, params["shared_attn"], x, pos,
                                   cache=a_cache, cache_index=cache_index,
                                   make_cache=make_cache)
            new_attn.append(na)
        if make_cache:
            return x, {"mamba": _stack(new_mamba, torch.cat),
                       "attn": _stack(new_attn)}
        return x, caches

    # ----------------------------------------------------------- serving
    @staticmethod
    def pad_cache(cache: dict, pad_to: int) -> dict:
        """Grow prompt-sized KV caches to the serving max length (the
        sequence axis is axis 2 of the k/v/ckv/k_rope leaves; SSM states
        and cross-attention K/V are length-free)."""
        def pad(name, leaf):
            if isinstance(leaf, dict):
                return {k: pad(k, v) for k, v in leaf.items()}
            if name in ("k", "v", "ckv", "k_rope") and leaf.shape[2] < pad_to:
                extra = list(leaf.shape)
                extra[2] = pad_to - leaf.shape[2]
                return torch.cat([leaf, leaf.new_zeros(extra)], dim=2)
            return leaf
        return pad(None, cache)

    def prefill(self, params, *, tokens=None, embeds=None, enc_embeds=None
                ) -> Tuple[torch.Tensor, dict]:
        """Process the prompt; return (last-position logits, cache)."""
        cfg, rules = self.cfg, self.rules
        x = self._embed(params, tokens, embeds)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        cache: Dict[str, Any] = {}
        if cfg.family == "dense":
            x, cache["blocks"], _ = _scan_blocks(
                cfg, rules, params["blocks"], x, pos, kind="attn",
                make_cache=True)
        elif cfg.family == "moe":
            if cfg.n_dense_layers:
                x, cache["dense_blocks"], _ = _scan_blocks(
                    cfg, rules, params["dense_blocks"], x, pos, kind="attn",
                    make_cache=True)
            x, cache["moe_blocks"], _ = _scan_blocks(
                cfg, rules, params["moe_blocks"], x, pos, kind="attn",
                make_cache=True)
        elif cfg.family == "ssm":
            x, cache["blocks"], _ = _scan_blocks(
                cfg, rules, params["blocks"], x, pos, kind="mamba",
                make_cache=True)
        elif cfg.family == "hybrid":
            x, cache = self._hybrid_stack(params, x, pos, make_cache=True)
        elif cfg.family == "encdec":
            enc = self._encode(params, enc_embeds)
            x, cache["dec_blocks"], _ = _scan_blocks(
                cfg, rules, params["dec_blocks"], x, pos, kind="attn",
                enc_out=enc, make_cache=True)
        return self._logits(params, x[:, -1:, :]), cache

    def decode(self, params, cache: dict, token: torch.Tensor,
               pos_index: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step.  token: (B,) int; pos_index: (B,) int (number
        of tokens already in the cache).  The cache is updated in place
        and returned."""
        cfg, rules = self.cfg, self.rules
        x = params["embed"][token[:, None]]
        positions = pos_index[:, None]
        if cfg.family == "hybrid":
            x, _ = self._hybrid_stack(params, x, positions, caches=cache,
                                      cache_index=pos_index)
        else:
            kind = "mamba" if cfg.family == "ssm" else "attn"
            groups = {"encdec": ("dec_blocks",),
                      "moe": ("dense_blocks", "moe_blocks")}.get(
                cfg.family, ("blocks",))
            for g in groups:
                if g in cache:
                    x, _, _ = _scan_blocks(cfg, rules, params[g], x,
                                           positions, kind=kind,
                                           caches=cache[g],
                                           cache_index=pos_index)
        logits = self._logits(params, x)
        return logits[:, 0, :], cache
