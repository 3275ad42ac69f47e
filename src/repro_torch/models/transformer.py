"""Model assembly for the five families (dense / moe / ssm / hybrid /
encdec).

The counterpart of the reference's ``models/transformer.py``.  Layers
are *stacked* (leading L dim, as in the reference's parameter tree) and
driven by a Python loop over L in place of ``lax.scan``: each stack is
unbound once into its layers before the loop, so the backward pass
writes one stack-sized gradient a stack, as the reference's scan does
(indexing a layer at a time would write one a layer).  Under a mesh
every leaf is stored at its placement (``models/sharding.py``) and a
layer gathers its own leaves just before it runs, inside its remat
region, so no gathered weight outlives its layer.  It gathers them over
the batch/FSDP axes only and computes on its model blocks (heads, ff,
experts; the vocab of the embedding and the logits, by
``core.distributed``'s vocab-parallel lookup and cross-entropy), but for
the leaves :func:`whole_on_model` names.
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
place and returns it.  Under a mesh a cache is held at the reference's
cache placement (kv heads on the model axis where it divides them, else
the head dim; the sequence on "data" where the batch axes do not divide
the batch): prefill keeps each layer's block and marks every leaf with
its placement, and decode gathers a layer's cache over the axes the
layer does not consume by block, then writes its block back.
``abstract`` and ``abstract_cache`` give the same trees as fake tensors
carrying their placements, for the dry-run (``launch/dryrun.py``).  With
a mesh, prefill and decode return this rank's vocab block of the
logits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..tree import tree_flatten, tree_map, tree_unflatten
from .attention import gqa_attention, head_split, make_attn_params, \
    make_mla_params, mla_attention
from .layers import (Maker, apply_norm, make_mlp_params, mlp,
                     model_replicated, wide)
from .moe import make_moe_params, moe_block
from .sharding import (MeshRules, NO_MESH, Placement, abstract_leaf,
                       block_of, gather, global_shape, layer_placement,
                       place, placement_of)
from .ssm import make_mamba_params, mamba_block


class _Stacked:
    """Maker proxy that prepends the layer dimension to every param."""

    def __init__(self, base: Maker, n: int):
        self._base = base
        self._n = n

    def param(self, shape, logical, **kw):
        return self._base.param((self._n,) + tuple(shape),
                                (None,) + tuple(logical), stacked=True,
                                **kw)

    def ones(self, shape, logical, **kw):
        return self._base.ones((self._n,) + tuple(shape),
                               (None,) + tuple(logical), **kw)


def _dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.dtype, torch.float32)


# the SSM mixer's leaves whose stored blocks mix its parts (z, x, B, C
# and dt; x, B and C for the conv): gathered whole and used by parts
_MIXER_PARTS = ("in_proj", "conv_w", "conv_b")


def whole_on_model(cfg, rules: MeshRules):
    """The ``model`` argument of ``MeshRules.gather_tree``: a block's
    leaf at ``path`` (its keys within the block) to its mode over the
    model axis, "block" (taken as held) but for a consumer that does
    not take its model block as it is held.

    "whole" (every model rank computes on the whole leaf alike):

    * GQA's ``wk``/``wv`` where the model axis does not divide the kv
      heads (the rank picks the ones its q heads read), and ``wq`` too
      where it does not divide the q heads (every head, as the
      reference's fitted constraint leaves q whole);
    * MLA's ``wq_b``/``wkv_b`` where it does not divide MLA's heads
      (every rank computes every head and takes its block at ``wo``);
    * every leaf of the SSM mixer ("mixer") where it does not divide the
      SSM heads (every rank computes the whole mixer).

    "parts" (each model rank uses its own parts of the whole leaf): the
    mixer's ``in_proj``, ``conv_w`` and ``conv_b`` where the model axis
    divides the SSM heads.  Their columns concatenate z, x, B, C and dt
    (x, B and C), so a contiguous column block mixes them; the rank
    takes its heads' columns and all of B and C (``ssm.py``).  The
    mixer's ``norm`` and ``out_proj`` are its heads' blocks as held."""
    split_model = rules.axis_size(rules.model_axis) > 1
    n, kv_split = head_split(cfg, rules) if cfg.n_heads else (1, False)
    attn = set()
    if split_model and n == 1:
        attn |= {"wq_b", "wkv_b"} if cfg.use_mla else {"wq"}
    if split_model and not cfg.use_mla and not kv_split:
        attn |= {"wk", "wv"}
    mixer_split = rules.model_ways(cfg.ssm_heads) > 1

    def mode(path) -> str:
        if "mixer" in path:
            if mixer_split:
                return "parts" if path[-1] in _MIXER_PARTS else "block"
            return "whole" if split_model else "block"
        if (len(path) >= 2 and path[-1] in attn
                and path[-2] in ("attn", "cross")):
            return "whole"
        return "block"
    return mode


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


def _unbind(tree) -> list:
    """The per-layer trees of a stacked (leading-L) tree: one
    ``unbind(0)`` a leaf (views), whose backward pass stacks the layers'
    gradients once."""
    paths, leaves = tree_flatten(tree)
    return [tree_unflatten(paths, list(layer))
            for layer in zip(*(leaf.unbind(0) for leaf in leaves))]


def _stack(parts, join=torch.stack):
    """Per-layer (or per-segment) trees joined leaf by leaf."""
    return tree_map(lambda *xs: join(xs), *parts)


# the cache leaves of which a layer makes and reads its model block, by
# the dim (of one layer's leaf, batch first) that holds it: a KV cache's
# kv heads and the SSM state's heads
_BLOCK_DIM = {"k": 2, "v": 2, "cross_k": 2, "cross_v": 2, "ssm": 1}


def _cache_places(places) -> Any:
    """One layer's placements of the dims a layer's cache is cut to at
    prefill and gathered over at decode, from the stacked cache's tree of
    placements (None: held whole): every axis of the placement but the
    batch dim (axis 1: this rank's slice of the batch, as every
    activation is) and a model axis on the heads of a KV cache or an
    SSM state (the layer makes and reads its block of them; the conv
    state's channels and MLA's ``ckv`` are gathered).  None when nothing
    is placed."""
    if places is None:
        return None

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node is None:
            return None
        spec = [None] + list(node.spec[2:])
        if name in _BLOCK_DIM:
            spec[_BLOCK_DIM[name]] = None
        if all(a is None for a in spec):
            return None
        return Placement(node.mesh, tuple(spec))
    out = walk(places)
    return (None if all(p is None for p in tree_flatten(out)[1])
            else out)


def _held_places(cache) -> Any:
    """The placements a held cache's leaves carry (see
    :meth:`Model.prefill`; the dry-run's abstract caches carry theirs)."""
    return tree_map(placement_of, cache)


def _open_cache(held, places):
    """A layer's cache at the value it reads: gathered over the dims of
    ``places`` (:func:`_cache_places`), else itself."""
    if places is None or held is None:
        return held
    return tree_map(gather, held, places)


def _close_cache(held, whole, places) -> None:
    """Write this rank's block of a gathered layer cache, updated in
    place by the step, back into the cache it holds."""
    if places is None or held is None:
        return
    for h, w, pl in zip(*(tree_flatten(t)[1] for t in (held, whole,
                                                       places))):
        if w is not h:
            h.copy_(block_of(w, pl))


def _cut_cache(made, places):
    """A layer's new cache kept at its block (:func:`_cache_places`)."""
    if places is None or made is None:
        return made
    return tree_map(place, made, places)


def _scan_blocks(cfg, rules, layers, x, positions, *, kind, place=None,
                 caches=None, cache_places=None, cache_index=None,
                 make_cache=False, causal=True, enc_out=None, remat=False,
                 q_chunk=1024):
    """Run a homogeneous group layer by layer: ``layers`` is its list of
    per-layer parameter trees (:func:`_unbind`) and ``place`` one layer's
    placement tree, by which each layer gathers its leaves first (None:
    nothing is placed; the model axis only for :func:`whole_on_model`'s
    leaves).  Returns (x, caches, aux): with ``make_cache`` the per-layer
    caches, each cut to its block by ``cache_places``, stacked on a new
    leading L axis; with ``caches`` the same caches, updated in place
    (``cache_places``: :func:`_cache_places` of them); ``aux`` the MoE
    layers' aux loss and drop fraction summed (empty for a group without
    MoE layers).  With
    ``remat`` and grad mode on, each layer keeps only its input for the
    backward pass and recomputes the rest there, its gathers included
    (the reference's ``jax.checkpoint``)."""
    how = whole_on_model(cfg, rules) if place is not None else None

    def block(x, lp, lcache):
        if place is not None:
            lp = rules.gather_tree(lp, place, model=how)
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

    made, aux_sum = [], None
    for i, lp in enumerate(layers):
        held = (tree_map(lambda a: a[i], caches)
                if caches is not None else None)
        lcache = _open_cache(held, cache_places)
        x, ncache, aux = block(x, lp, lcache)
        _close_cache(held, lcache, cache_places)
        if aux:  # a MoE layer
            vec = torch.stack([aux["moe_aux_loss"], aux["moe_drop_frac"]])
            aux_sum = vec if aux_sum is None else aux_sum + vec
        if make_cache:
            made.append(_cut_cache(ncache, cache_places))
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
        CPU), each held at its placement under a mesh: every rank draws
        the same numbers and keeps its block.  The numbers differ from
        the reference's ``jax.random`` ones;
        ``models.convert.params_from_reference`` carries the reference's
        tree over instead."""
        gen = torch.Generator(device=device).manual_seed(seed)
        return build_params(self.cfg, "init", self.rules, gen, device)

    def placements(self) -> dict:
        """The parameter tree's placements (``Placement`` or None a
        leaf): where each leaf is held, and what a layer gathers."""
        if "_placements" not in self.__dict__:
            self.__dict__["_placements"] = build_params(
                self.cfg, "placement", self.rules)
        return self.__dict__["_placements"]

    def _whole(self, params, name):
        """``params[name]`` (a leaf or a block's tree) as a layer uses it:
        gathered over the batch/FSDP axes where it is placed (and over
        the model axis for :func:`whole_on_model`'s leaves)."""
        if self.rules.mesh is None:
            return params[name]
        return self.rules.gather_tree(params[name], self.placements()[name],
                                      model=whole_on_model(self.cfg,
                                                           self.rules))

    def _group(self, params, name) -> dict:
        """The keyword arguments of :func:`_scan_blocks` for the stacked
        group ``name``: its layers and one layer's placements."""
        place = None
        if self.rules.mesh is not None:
            place = tree_map(layer_placement, self.placements()[name])
        return {"layers": _unbind(params[name]), "place": place}

    def abstract(self, device="cuda") -> dict:
        """The parameter tree as fake tensors on ``device``, each with
        the placement ``rules.fitted_sharding`` gives it (the
        reference's ``ShapeDtypeStruct``s): inside an active
        ``FakeTensorMode`` only."""
        return build_params(self.cfg, "abstract", self.rules, None, device)

    def abstract_cache(self, batch: int, max_len: int,
                       enc_len: Optional[int] = None, device="cuda") -> dict:
        """The serving cache's tree as fake tensors with placements, for
        decode dry-runs (inside an active ``FakeTensorMode``); the
        placements are :meth:`cache_placements`'."""
        def leaf(rules, shape, dtype, *logical):
            return abstract_leaf(shape, dtype, device,
                                 rules.fitted_sharding(shape, *logical))
        return self._cache_tree(batch, max_len, enc_len, leaf)

    def cache_placements(self, batch: int, max_len: int,
                         enc_len: Optional[int] = None) -> dict:
        """The serving cache's tree of placements (the reference's): the
        batch on the batch axes, or, when they do not divide it (a long
        single-sequence decode), the sequence over ``data``; kv heads on
        the model axis where it divides them, else the head dim."""
        def leaf(rules, shape, dtype, *logical):
            return rules.fitted_sharding(shape, *logical)
        return self._cache_tree(batch, max_len, enc_len, leaf)

    def _cache_tree(self, batch, max_len, enc_len, make) -> dict:
        cfg = self.cfg
        dt = _dtype_of(cfg)
        rules = self.rules
        hd = cfg.resolved_head_dim
        Hkv = cfg.n_kv_heads
        model_n = rules.axis_size(rules.model_axis)
        batch_ok = rules.batch_size_divides(batch)
        b_ax = "batch" if batch_ok else None
        s_ax = None if batch_ok else "seq"
        if not batch_ok:
            rules = dataclasses.replace(rules, seq_axis=rules.fsdp_axis)
        if Hkv and Hkv % model_n == 0:
            h_ax, d_ax = "kv", None
        elif hd and hd % model_n == 0:
            h_ax, d_ax = None, "model"
        else:
            h_ax, d_ax = None, None

        def leaf(shape, *logical, dtype=dt):
            return make(rules, shape, dtype, *logical)

        def kv_cache(L):
            return {"k": leaf((L, batch, max_len, Hkv, hd),
                              None, b_ax, s_ax, h_ax, d_ax),
                    "v": leaf((L, batch, max_len, Hkv, hd),
                              None, b_ax, s_ax, h_ax, d_ax)}

        def mla_cache(L):
            r_ax = "model" if cfg.kv_lora_rank % model_n == 0 else None
            return {"ckv": leaf((L, batch, max_len, cfg.kv_lora_rank),
                                None, b_ax, s_ax, r_ax),
                    "k_rope": leaf((L, batch, max_len, cfg.qk_rope_head_dim),
                                   None, b_ax, s_ax, None)}

        def mamba_state(L):
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            c_ax = "model" if conv_dim % model_n == 0 else None
            h_ax2 = "model" if cfg.ssm_heads % model_n == 0 else None
            return {
                "conv": leaf((L, batch, cfg.ssm_conv - 1, conv_dim),
                             None, b_ax, None, c_ax),
                "ssm": leaf((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state), None, b_ax, h_ax2, None, None,
                            dtype=torch.promote_types(torch.float32, dt)),
            }

        if cfg.family == "dense":
            return {"blocks": (mla_cache(cfg.n_layers) if cfg.use_mla
                               else kv_cache(cfg.n_layers))}
        if cfg.family == "moe":
            mkc = mla_cache if cfg.use_mla else kv_cache
            out = {"moe_blocks": mkc(cfg.n_layers - cfg.n_dense_layers)}
            if cfg.n_dense_layers:
                out["dense_blocks"] = mkc(cfg.n_dense_layers)
            return out
        if cfg.family == "ssm":
            return {"blocks": mamba_state(cfg.n_layers)}
        if cfg.family == "hybrid":
            n_seg = cfg.n_layers // cfg.attn_every
            return {"mamba": mamba_state(cfg.n_layers),
                    "attn": kv_cache(n_seg)}
        if cfg.family == "encdec":
            c = kv_cache(cfg.n_layers)
            for name in ("cross_k", "cross_v"):
                c[name] = leaf((cfg.n_layers, batch, enc_len or max_len,
                                Hkv, hd), None, b_ax, None, h_ax, d_ax)
            return {"dec_blocks": c}
        raise ValueError(cfg.family)

    # ------------------------------------------------------------ embed
    def _vocab_block(self):
        """(model group, first vocab id) of this rank's vocab block where
        the model axis splits the vocab, else None."""
        rules, V = self.rules, self.cfg.vocab_size
        n = rules.model_ways(V)
        if n == 1:
            return None
        return (rules.group(rules.model_axis),
                rules.coordinate(rules.model_axis) * (V // n))

    def _embed(self, params, tokens=None, embeds=None):
        if embeds is not None:
            return embeds.to(_dtype_of(self.cfg))
        table = self._whole(params, "embed")
        block = self._vocab_block()
        if block is None:
            return table[tokens]
        from ..core.distributed import vocab_parallel_embed
        return vocab_parallel_embed(table, tokens, *block)

    def head_matrix(self, params) -> torch.Tensor:
        """(d_model, vocab) unembedding matrix: under a mesh this rank's
        (d_model, vocab / n) block where the model axis splits the
        vocab."""
        return (self._whole(params, "embed").T if self.cfg.tie_embeddings
                else self._whole(params, "lm_head"))

    def _logits(self, params, x):
        """float32 logits: the reference's dot with
        preferred_element_type=f32, i.e. products of the stored values
        summed in f32 (not a bf16 result widened afterwards); this
        rank's vocab block under a mesh that splits the vocab."""
        x = apply_norm(self.cfg, x, self._whole(params, "final_norm"))
        head = self.head_matrix(params).to(x.dtype)
        if self._vocab_block() is not None:
            x = model_replicated(x, self.rules)
        logits = torch.matmul(wide(x), wide(head))
        return self.rules.constrain(logits, "batch", "seq", "model")

    def _encode(self, params, enc_embeds, remat=False):
        cfg, rules = self.cfg, self.rules
        x = enc_embeds.to(_dtype_of(cfg))
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, _, _ = _scan_blocks(cfg, rules, x=x, positions=pos,
                               **self._group(params, "enc_blocks"),
                               kind="attn", causal=False, remat=remat)
        return apply_norm(cfg, x, self._whole(params, "enc_norm"))

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

        def scan(name, x, **kw):
            return _scan_blocks(cfg, rules, x=x, positions=pos,
                                **self._group(params, name), remat=remat,
                                **kw)

        if cfg.family == "dense":
            x, _, _ = scan("blocks", x, kind="attn")
        elif cfg.family == "moe":
            if cfg.n_dense_layers:
                x, _, _ = scan("dense_blocks", x, kind="attn")
            x, _, aux = scan("moe_blocks", x, kind="attn")
            if cfg.mtp:
                xm, _, _ = _attn_block(
                    cfg, rules, self._whole(params, "mtp_block"),
                    apply_norm(cfg, x, self._whole(params, "mtp_norm")), pos)
                aux["mtp_hidden"] = xm
        elif cfg.family == "ssm":
            x, _, _ = scan("blocks", x, kind="mamba")
        elif cfg.family == "hybrid":
            x, _ = self._hybrid_stack(params, x, pos, remat=remat)
        elif cfg.family == "encdec":
            enc = self._encode(params, enc_embeds, remat)
            x, _, _ = scan("dec_blocks", x, kind="attn", enc_out=enc)
        if return_hidden:
            final = self._whole(params, "final_norm")
            xh = apply_norm(cfg, x, final)
            if "mtp_hidden" in aux:
                aux["mtp_hidden"] = apply_norm(cfg, aux["mtp_hidden"], final)
            return xh, aux
        logits = self._logits(params, x)
        if "mtp_hidden" in aux:
            aux["mtp_logits"] = self._logits(params, aux.pop("mtp_hidden"))
        return logits, aux

    def _hybrid_stack(self, params, x, pos, *, caches=None,
                      cache_index=None, make_cache=False, remat=False,
                      cut=None):
        """Zamba2: segments of ``attn_every`` Mamba layers, each followed
        by THE shared attention block (weights reused; caches distinct).
        Returns (x, cache): with ``make_cache`` the Mamba states
        concatenated over the layers and the shared block's K/V stacked
        over its applications, each layer's cut by ``cut`` ({"mamba",
        "attn"}: :func:`_cache_places`); with ``caches`` the same
        caches, updated in place."""
        cfg, rules = self.cfg, self.rules
        period = cfg.attn_every
        n_seg = cfg.n_layers // period
        bounds = [(s * period, (s + 1) * period) for s in range(n_seg)]
        if cfg.n_layers > n_seg * period:
            bounds.append((n_seg * period, cfg.n_layers))
        group = self._group(params, "blocks")
        places = ({k: _cache_places(_held_places(v))
                   for k, v in caches.items()} if caches is not None
                  else (cut or {}))
        new_mamba, new_attn = [], []
        for s, (lo, hi) in enumerate(bounds):
            seg_cache = (_layers(caches["mamba"], lo, hi)
                         if caches is not None else None)
            x, nm, _ = _scan_blocks(cfg, rules, group["layers"][lo:hi], x,
                                    pos, kind="mamba", place=group["place"],
                                    caches=seg_cache,
                                    cache_places=places.get("mamba"),
                                    make_cache=make_cache,
                                    cache_index=cache_index, remat=remat)
            new_mamba.append(nm)
            if s == n_seg:  # the remainder: no shared block after it
                break
            held = (tree_map(lambda a: a[s], caches["attn"])
                    if caches is not None else None)
            a_cache = _open_cache(held, places.get("attn"))
            x, na, _ = _attn_block(cfg, rules,
                                   self._whole(params, "shared_attn"), x,
                                   pos, cache=a_cache,
                                   cache_index=cache_index,
                                   make_cache=make_cache)
            _close_cache(held, a_cache, places.get("attn"))
            new_attn.append(_cut_cache(na, places.get("attn"))
                            if make_cache else na)
        if make_cache:
            return x, {"mamba": _stack(new_mamba, torch.cat),
                       "attn": _stack(new_attn)}
        return x, caches

    # ----------------------------------------------------------- serving
    def _split(self, split: bool) -> MeshRules:
        """The rules a serving step's layers run with: ``batch_split``
        where ``split`` says each rank holds its own slice of the batch
        (the MoE's statistics, capacity and slot order are then the
        global batch's), else this model's."""
        if not split:
            return self.rules
        return dataclasses.replace(self.rules, batch_split=True)

    @staticmethod
    def pad_cache(cache: dict, pad_to: int) -> dict:
        """Grow prompt-sized KV caches to the serving max length (the
        sequence axis is axis 2 of the k/v/ckv/k_rope leaves; SSM states
        and cross-attention K/V are length-free).  A leaf held at a
        placement keeps it: where the sequence is split, it is gathered,
        grown and cut again, so each rank holds its block of the grown
        sequence."""
        def pad(name, leaf):
            if isinstance(leaf, dict):
                return {k: pad(k, v) for k, v in leaf.items()}
            placement = placement_of(leaf)
            if name not in ("k", "v", "ckv", "k_rope") or \
                    global_shape(leaf)[2] >= pad_to:
                return leaf
            seq = None
            if placement is not None and placement.spec[2] is not None:
                seq = Placement(placement.mesh, tuple(
                    ax if i == 2 else None
                    for i, ax in enumerate(placement.spec)))
            whole = gather(leaf, seq)
            extra = list(whole.shape)
            extra[2] = pad_to - whole.shape[2]
            out = place(torch.cat([whole, whole.new_zeros(extra)], dim=2),
                        seq)
            if placement is not None:
                out.placement = placement
            return out
        return pad(None, cache)

    def prefill(self, params, *, tokens=None, embeds=None, enc_embeds=None,
                global_batch: Optional[int] = None
                ) -> Tuple[torch.Tensor, dict]:
        """Process the prompt; return (last-position logits, cache).
        Under a mesh the cache is held at :meth:`cache_placements` for
        ``global_batch`` (default: this rank's batch is its slice along
        the batch axes; pass the batch's size where every rank holds it
        whole), each leaf carrying its placement for :meth:`decode`.
        Where the ranks hold slices of the batch, the layers run with
        ``batch_split`` (:meth:`_split`), so the MoE takes its capacity
        and slot order from the global batch, as the reference's GSPMD
        prefill does."""
        cfg, rules = self.cfg, self.rules
        x = self._embed(params, tokens, embeds)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        cache: Dict[str, Any] = {}
        places = None
        if rules.mesh is not None:
            global_batch = global_batch or x.shape[0] * rules.axis_size(
                rules.batch_axes)
            places = self.cache_placements(
                global_batch, x.shape[1], None if enc_embeds is None
                else enc_embeds.shape[1])
            rules = self._split(global_batch != x.shape[0])

        def cut(name):
            return None if places is None else _cache_places(places[name])

        def scan(name, x, **kw):
            return _scan_blocks(cfg, rules, x=x, positions=pos,
                                **self._group(params, name),
                                make_cache=True, cache_places=cut(name),
                                **kw)

        if cfg.family == "dense":
            x, cache["blocks"], _ = scan("blocks", x, kind="attn")
        elif cfg.family == "moe":
            if cfg.n_dense_layers:
                x, cache["dense_blocks"], _ = scan("dense_blocks", x,
                                                   kind="attn")
            x, cache["moe_blocks"], _ = scan("moe_blocks", x, kind="attn")
        elif cfg.family == "ssm":
            x, cache["blocks"], _ = scan("blocks", x, kind="mamba")
        elif cfg.family == "hybrid":
            x, cache = self._hybrid_stack(
                params, x, pos, make_cache=True,
                cut=None if places is None else {k: cut(k) for k in places})
        elif cfg.family == "encdec":
            enc = self._encode(params, enc_embeds)
            x, cache["dec_blocks"], _ = scan("dec_blocks", x, kind="attn",
                                             enc_out=enc)
        if places is not None:
            for leaf, pl in zip(tree_flatten(cache)[1],
                                tree_flatten(places)[1]):
                leaf.placement = pl
        return self._logits(params, x[:, -1:, :]), cache

    def decode(self, params, cache: dict, token: torch.Tensor,
               pos_index: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step.  token: (B,) int; pos_index: (B,) int (number
        of tokens already in the cache).  The cache is updated in place
        and returned.  Whether the ranks hold slices of the batch is read
        from the cache's placements (:meth:`prefill` places its batch dim
        on the batch axes only then), and the layers run with
        ``batch_split`` where they do, as in :meth:`prefill`."""
        cfg = self.cfg
        rules = self._split(any(
            pl is not None and pl.spec[1] is not None
            for pl in tree_flatten(_held_places(cache))[1]))
        x = self._embed(params, token[:, None])
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
                    x, _, _ = _scan_blocks(
                        cfg, rules, x=x, positions=positions,
                        **self._group(params, g), kind=kind,
                        caches=cache[g],
                        cache_places=_cache_places(_held_places(cache[g])),
                        cache_index=pos_index)
        logits = self._logits(params, x)
        return logits[:, 0, :], cache
