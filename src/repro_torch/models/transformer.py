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
region, so no gathered weight outlives its layer.
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
place and returns it.  ``abstract`` and ``abstract_cache`` give the
same trees as fake tensors carrying their placements, for the dry-run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..tree import tree_flatten, tree_map, tree_unflatten
from .attention import gqa_attention, make_attn_params, make_mla_params, \
    mla_attention
from .layers import Maker, apply_norm, make_mlp_params, mlp
from .moe import make_moe_params, moe_block
from .sharding import (MeshRules, NO_MESH, Placement, abstract_leaf,
                       block_of, gather, layer_placement, placement_of)
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


def _cache_places(cache) -> Any:
    """One layer's placements of a stacked cache tree, with the batch dim
    (axis 1) taken as held already (it is this rank's slice of the
    batch, as every activation is); None for a cache held whole (one
    made by prefill)."""
    def one(t):
        pl = placement_of(t)
        if pl is None:
            return None
        return Placement(pl.mesh, (None,) + tuple(pl.spec[2:]))
    places = tree_map(one, cache)
    return (None if all(p is None for p in tree_flatten(places)[1])
            else places)


def _open_cache(held, places):
    """A layer's cache at its global value: gathered where it is held at
    a placement (a dry-run's decode), else itself."""
    if places is None:
        return held
    return tree_map(gather, held, places)


def _close_cache(held, whole, places) -> None:
    """Write this rank's block of a gathered layer cache, updated in
    place by the step, back into the cache it holds."""
    if places is None:
        return
    for h, w, pl in zip(*(tree_flatten(t)[1] for t in (held, whole,
                                                       places))):
        if w is not h:
            h.copy_(block_of(w, pl))


def _scan_blocks(cfg, rules, layers, x, positions, *, kind, place=None,
                 caches=None, cache_places=None, cache_index=None,
                 make_cache=False, causal=True, enc_out=None, remat=False,
                 q_chunk=1024):
    """Run a homogeneous group layer by layer: ``layers`` is its list of
    per-layer parameter trees (:func:`_unbind`) and ``place`` one layer's
    placement tree, by which each layer gathers its leaves first (None:
    nothing is placed).  Returns (x, caches, aux): with ``make_cache``
    the per-layer caches stacked on a new leading L axis; with
    ``caches`` the same caches, updated in place (``cache_places``:
    :func:`_cache_places` of them); ``aux`` the MoE layers' aux loss and
    drop fraction summed (empty for a group without MoE layers).  With
    ``remat`` and grad mode on, each layer keeps only its input for the
    backward pass and recomputes the rest there, its gathers included
    (the reference's ``jax.checkpoint``)."""
    def block(x, lp, lcache):
        if place is not None:
            lp = rules.gather_tree(lp, place)
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
        """``params[name]`` (a leaf or a block's tree) at its global
        value, gathered where it is placed."""
        if self.rules.mesh is None:
            return params[name]
        return self.rules.gather_tree(params[name], self.placements()[name])

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
        decode dry-runs (inside an active ``FakeTensorMode``).  The
        placements are the reference's: the batch on the batch axes, or,
        when they do not divide it (a long single-sequence decode), the
        sequence over ``data``; kv heads on the model axis where it
        divides them, else the head dim."""
        cfg = self.cfg
        dt = _dtype_of(cfg)
        rules = self.rules

        def leaf(shape, *logical, dtype=dt):
            return abstract_leaf(shape, dtype, device,
                                 rules.fitted_sharding(shape, *logical))

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
                            dtype=torch.float32),
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
    def _embed(self, params, tokens=None, embeds=None):
        if embeds is not None:
            return embeds.to(_dtype_of(self.cfg))
        return self._whole(params, "embed")[tokens]

    def head_matrix(self, params) -> torch.Tensor:
        """(d_model, vocab) unembedding matrix, at its global value."""
        return (self._whole(params, "embed").T if self.cfg.tie_embeddings
                else self._whole(params, "lm_head"))

    def _logits(self, params, x):
        """float32 logits: the reference's dot with
        preferred_element_type=f32, i.e. products of the stored values
        summed in f32 (not a bf16 result widened afterwards)."""
        x = apply_norm(self.cfg, x, self._whole(params, "final_norm"))
        head = self.head_matrix(params).to(x.dtype)
        logits = torch.matmul(x.float(), head.float())
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
        group = self._group(params, "blocks")
        places = {k: _cache_places(v) for k, v in (caches or {}).items()}
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

        def scan(name, x, **kw):
            return _scan_blocks(cfg, rules, x=x, positions=pos,
                                **self._group(params, name),
                                make_cache=True, **kw)

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
            x, cache = self._hybrid_stack(params, x, pos, make_cache=True)
        elif cfg.family == "encdec":
            enc = self._encode(params, enc_embeds)
            x, cache["dec_blocks"], _ = scan("dec_blocks", x, kind="attn",
                                             enc_out=enc)
        return self._logits(params, x[:, -1:, :]), cache

    def decode(self, params, cache: dict, token: torch.Tensor,
               pos_index: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """One decode step.  token: (B,) int; pos_index: (B,) int (number
        of tokens already in the cache).  The cache is updated in place
        and returned."""
        cfg, rules = self.cfg, self.rules
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
                        cache_places=_cache_places(cache[g]),
                        cache_index=pos_index)
        logits = self._logits(params, x)
        return logits[:, 0, :], cache
