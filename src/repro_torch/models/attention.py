"""Attention: GQA (with qk-norm), MLA (DeepSeek), cross-attention, KV
caches for serving, and query-chunked computation for long prefills.

The counterpart of the reference's ``models/attention.py``.
Softmax/score math in f32; weights and activations in the config dtype.
MLA's train and prefill expand K/V and take the plain chunked path (its
qk head dim is not its v head dim, so it never reaches the flash
kernel, as in the reference); its decode is the *absorbed* formulation
over a compressed (c_kv, shared RoPE key) cache, the published
DeepSeek-V3 serving scheme.

Under a model axis of n ranks that divides the q heads, a rank computes
its H/n heads (``head_split``): ``wq`` is its column block and ``wo``
its row block (``row_parallel_matmul``); ``wk``/``wv`` are its blocks
of the kv heads where n divides those too, else whole, and the rank
picks the kv heads its q heads read (the reference's fitted "kv"
constraint).  Where n does not divide the q heads the layer computes
every head, with ``wq``/``wk``/``wv`` gathered whole, and takes its
block of them at ``wo``.  MLA splits its heads the same way: the
columns of ``wq_b`` (nope then rope a head) and ``wkv_b`` (k then v a
head) are head-major, so their stored column blocks are this rank's H/n
whole heads, used as they are held; ``cq``, ``ckv`` and the RoPE key,
which every rank computes alike, enter with an all-reduced gradient.
Where n does not divide MLA's heads, ``wq_b``/``wkv_b`` are gathered
whole and the rank takes its block at ``wo``, as GQA does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.spans import span
# imported with the model, not at the first prefill: importing it
# registers K5's operator and its FLOP formula, which a FlopCounterMode
# copies when it is made (the dry-run makes one before its first layer)
from ..kernels import flash_attention as _kfa
from .layers import (Maker, apply_rope, model_replicated, rms_norm,
                     rope_angles, row_parallel_matmul, wide)
from .sharding import MeshRules

DEFAULT_Q_CHUNK = 1024

# Attention backend for train/prefill self-attention:
#   "sdpa"  — chunked einsum attention in plain torch (the reference's
#             "xla" backend)
#   "flash" — the hand-written flash-attention kernel (the reference's
#             "pallas", its TPU target; the reference's _FLASH_INTERPRET
#             = False is that setting on a real TPU).  On CPU tensors the
#             kernel's plain version runs.  The kernel is forward-only, as
#             the reference's is, so inputs that require grad (training)
#             take the "sdpa" path whatever this says.
# Decode and cross-attention always take the "sdpa" path: in the
# reference they are einsums, not a Pallas kernel.
ATTENTION_BACKEND = "flash"


# ---------------------------------------------------------------- params
def make_attn_params(mk: Maker, cfg) -> dict:
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": mk.param((d, H * hd), ("embed", "model")),
        "wk": mk.param((d, Hkv * hd), ("embed", "model")),
        "wv": mk.param((d, Hkv * hd), ("embed", "model")),
        "wo": mk.param((H * hd, d), ("model", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = mk.ones((hd,), (None,))
        p["k_norm"] = mk.ones((hd,), (None,))
    return p


def make_mla_params(mk: Maker, cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    qh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wq_a": mk.param((d, cfg.q_lora_rank), ("embed", None)),
        "q_a_norm": mk.ones((cfg.q_lora_rank,), (None,)),
        "wq_b": mk.param((cfg.q_lora_rank, H * qh), (None, "model")),
        "wkv_a": mk.param((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                          ("embed", None)),
        "kv_a_norm": mk.ones((cfg.kv_lora_rank,), (None,)),
        "wkv_b": mk.param(
            (cfg.kv_lora_rank,
             H * (cfg.qk_nope_head_dim + cfg.v_head_dim)), (None, "model")),
        "wo": mk.param((H * cfg.v_head_dim, d), ("model", "embed")),
    }


# ------------------------------------------------------------- core math
def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
          scale: float, kv_valid: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Grouped scaled-dot-product attention.
    q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv).
    qpos: (Sq,) or (B, Sq); kpos: (Skv,).  kv_valid: (B,) count of valid
    cache entries (decode).  Returns (B, Sq, H, Dv)."""
    B, Sq, H, Dk = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qf = wide(q.reshape(B, Sq, Hkv, G, Dk))
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, wide(k)) * scale

    if qpos.ndim == 1:
        qpos = qpos[None, :]
    mask = torch.ones((B, Sq, k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
    if kv_valid is not None:
        mask = mask & (kpos[None, None, :] < kv_valid[:, None, None])
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(-1e30, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, wide(v))
    return out.reshape(B, Sq, H, v.shape[-1]).to(v.dtype)


def _sdpa_chunked(q, k, v, qpos, kpos, *, causal, scale, kv_valid=None,
                  chunk=DEFAULT_Q_CHUNK):
    """Query-chunked SDPA: O(chunk * Skv) live scores instead of
    O(Sq * Skv) — the long-prefill memory saver; the last chunk takes
    the rows left over.  A causal call with as many keys as queries
    attends one sequence to itself (queries and keys at 0..S-1), so a
    chunk reads the keys up to its last row alone."""
    Sq = q.shape[1]
    if Sq <= chunk:
        return _sdpa(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                     scale=scale, kv_valid=kv_valid)
    self_causal = causal and k.shape[1] == Sq
    outs = []
    for lo in range(0, Sq, chunk):
        hi = min(lo + chunk, Sq)
        pi = qpos[lo:hi] if qpos.ndim == 1 else qpos[:, lo:hi]
        kh = hi if self_causal else k.shape[1]
        outs.append(_sdpa(q[:, lo:hi], k[:, :kh], v[:, :kh], qpos=pi,
                          kpos=kpos[:kh], causal=causal, scale=scale,
                          kv_valid=kv_valid))
    return torch.cat(outs, dim=1)


# ------------------------------------------------------- tensor parallel
def head_split(cfg, rules: MeshRules) -> Tuple[int, bool]:
    """(n, kv_split): the model ways over which a GQA layer splits its q
    heads (1: every rank computes every head), and whether its kv heads
    split the same way (else each rank projects them whole and picks
    the ones its q heads read)."""
    n = rules.model_ways(cfg.n_heads)
    return n, n > 1 and cfg.n_kv_heads % n == 0


def kv_heads_read(H: int, Hkv: int, n: int, c: int) -> list:
    """The kv heads that q heads ``c*H/n`` .. ``(c+1)*H/n`` read, in an
    order that keeps the grouped layout: each kv head once where the
    block spans whole groups or lies inside one, else one a q head."""
    G, hl = H // Hkv, H // n
    if hl % G == 0:
        return list(range(c * hl // G, (c + 1) * hl // G))
    if G % hl == 0:
        return [c * hl // G]
    return [h // G for h in range(c * hl, (c + 1) * hl)]


# ------------------------------------------------------------ GQA module
def gqa_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  rules: MeshRules, *,
                  cache: Optional[dict] = None,
                  cache_index: Optional[torch.Tensor] = None,
                  make_cache: bool = False,
                  causal: bool = True,
                  kv_input: Optional[torch.Tensor] = None,
                  q_chunk: int = DEFAULT_Q_CHUNK,
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention with optional KV cache.

    Modes:
      train:    cache=None, make_cache=False
      prefill:  make_cache=True -> returns cache sized to S
      decode:   cache given, cache_index = current position (B,); the
                step's K/V are written into the cache IN PLACE (the
                reference's functional dynamic_update_slice makes a new
                cache; writing in place saves that copy) and the same
                cache is returned
      cross:    kv_input = encoder states (cache stores projected K/V)
    """
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    n, kv_split = head_split(cfg, rules)
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if n > 1:
        # this rank's H/n heads: every input and replicated weight it
        # uses by its block enters with an all-reduced gradient
        x = model_replicated(x, rules)
        if kv_input is not None and cache is None:
            kv_input = model_replicated(kv_input, rules)
        if not kv_split:
            wk, wv = model_replicated(wk, rules), model_replicated(wv, rules)
        if cfg.qk_norm:
            q_norm = model_replicated(q_norm, rules)
            k_norm = model_replicated(k_norm, rules)
    Hl, Hk = H // n, (Hkv // n if kv_split else Hkv)
    q = (x @ p["wq"]).reshape(B, S, Hl, hd)
    kv_src = kv_input if kv_input is not None else x
    Skv_in = kv_src.shape[1]

    if cache is not None and kv_input is not None:
        # cross-attention decode: K/V were projected once at prefill
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        k = (kv_src @ wk).reshape(B, Skv_in, Hk, hd)
        v = (kv_src @ wv).reshape(B, Skv_in, Hk, hd)
        if cfg.qk_norm:
            q = rms_norm(q, q_norm, cfg.norm_eps)
            k = rms_norm(k, k_norm, cfg.norm_eps)
        if kv_input is None:  # RoPE only for self-attention
            cos, sin = rope_angles(positions, hd, cfg.rope_theta,
                                   wide(q).dtype)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        new_cache = None
        if cache is not None:
            # decode: write this step's K/V at cache_index, in place
            k_cache, v_cache = cache["k"], cache["v"]
            rows = torch.arange(B, device=k_cache.device)
            k_cache[rows, cache_index] = k[:, 0]
            v_cache[rows, cache_index] = v[:, 0]
            new_cache = cache
            k, v = k_cache, v_cache
        elif make_cache:
            new_cache = {"k": k, "v": v}

    if n > 1 and not kv_split:
        # whole kv heads (and caches): the ones this rank's q heads read
        idx = torch.tensor(kv_heads_read(H, Hkv, n, rules.coordinate(
            rules.model_axis)), device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)

    if cache is None:
        k = rules.constrain(k, "batch", None, "kv", None)
        v = rules.constrain(v, "batch", None, "kv", None)
        q = rules.constrain(q, "batch", None, "model", None)

    scale = 1.0 / math.sqrt(hd)
    Skv = k.shape[1]
    kpos = torch.arange(Skv, dtype=torch.int32, device=x.device)
    kv_valid = None
    if cache is not None and kv_input is None:
        kv_valid = cache_index + 1
        qpos = positions
        causal_eff = False  # masking handled by kv_valid
    else:
        qpos = positions
        causal_eff = causal and kv_input is None

    wants_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if (ATTENTION_BACKEND == "flash" and cache is None
            and kv_input is None and kv_valid is None and not wants_grad):
        out = _kfa.flash_attention(q, k, v, causal=causal_eff, scale=scale)
    else:
        out = _sdpa_chunked(q, k, v, qpos=qpos, kpos=kpos,
                            causal=causal_eff, scale=scale,
                            kv_valid=kv_valid, chunk=q_chunk)
    out = out.reshape(B, S, Hl * hd)
    if n == 1:   # every head here: wo's rows still take their block
        out = _head_block(out, rules)
    y = row_parallel_matmul(out, p["wo"], rules, H * hd)
    return y, new_cache


def _head_block(out: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """This rank's model block of the last dim of ``out``, computed alike
    on every model rank (its gradient all-reduced), where the model
    axis splits it; else ``out``."""
    n = rules.model_ways(out.shape[-1])
    if n == 1:
        return out
    f = out.shape[-1] // n
    lo = rules.coordinate(rules.model_axis) * f
    return model_replicated(out, rules)[..., lo:lo + f]


# ------------------------------------------------------------ MLA module
def _mla_qkv(cfg, p, x, rules: MeshRules, n: int):
    """q of this rank's H/n heads (every head where n is 1), c_kv and the
    RoPE key.  Where n > 1, ``wq_b`` is this rank's column block, and
    ``cq``, c_kv and the RoPE key, used by every rank's heads alike,
    enter with an all-reduced gradient."""
    B, S, _ = x.shape
    H = cfg.n_heads // n
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps)
    ckv_full = x @ p["wkv_a"]
    ckv = rms_norm(ckv_full[..., :cfg.kv_lora_rank], p["kv_a_norm"],
                   cfg.norm_eps)
    k_rope = ckv_full[..., cfg.kv_lora_rank:]
    if n > 1:
        cq, ckv, k_rope = (model_replicated(t, rules)
                           for t in (cq, ckv, k_rope))
    q = (cq @ p["wq_b"]).reshape(B, S, H, nope + rope)
    return q, ckv, k_rope


def mla_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  rules: MeshRules, *,
                  cache: Optional[dict] = None,
                  cache_index: Optional[torch.Tensor] = None,
                  make_cache: bool = False,
                  q_chunk: int = DEFAULT_Q_CHUNK,
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Multi-head latent attention.  Train/prefill (``cache`` None):
    K/V expanded from c_kv, causal attention on the plain chunked path;
    ``make_cache`` returns ``{"ckv": (B, S, r), "k_rope": (B, S, rope)}``.
    Decode: this step's c_kv and RoPE key are written into the cache at
    ``cache_index`` IN PLACE (as gqa_attention's K/V are), and attention
    runs against the compressed cache with W_uk absorbed into q and W_uv
    applied after, in f32.  Where the model axis splits the heads n
    ways, a rank runs both on its H/n heads (``wkv_b``'s column block
    gives its W_uk/W_uv) against the whole c_kv and RoPE key.  The
    config gives the RoPE frequencies (``cfg.rope_inv_freq``) and the
    softmax scale (``cfg.mla_softmax_scale()``): DeepSeek-V3's YaRN
    under ``DeepSeekV3Config``."""
    B, S, d = x.shape
    n = rules.model_ways(cfg.n_heads)
    H = cfg.n_heads // n
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd = cfg.v_head_dim
    scale = cfg.mla_softmax_scale()

    q, ckv, k_rope = _mla_qkv(cfg, p, x, rules, n)
    dt = wide(q).dtype
    cos, sin = rope_angles(positions, rope_d, cfg.rope_theta, dt,
                           cfg.rope_inv_freq(rope_d, dt, x.device))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is None:
        # train / prefill: expand K,V (no cache pressure), full attention
        with span("blasx.mla.prefill"):
            kv = (ckv @ p["wkv_b"]).reshape(B, S, H, nope + vd)
            k_nope, v = kv[..., :nope], kv[..., nope:]
            k = torch.cat([k_nope,
                           k_rope[:, :, None, :].expand(B, S, H, rope_d)],
                          dim=-1)
            qfull = torch.cat([q_nope, q_rope], dim=-1)
            out = _sdpa_chunked(qfull, k, v, qpos=positions,
                                kpos=torch.arange(S, dtype=torch.int32,
                                                  device=x.device),
                                causal=True, scale=scale, chunk=q_chunk)
        new_cache = {"ckv": ckv, "k_rope": k_rope} if make_cache else None
        return _mla_out(cfg, p, out.reshape(B, S, H * vd), rules, n), \
            new_cache

    # ---------------- absorbed decode: cache is compressed (c_kv, k_rope)
    with span("blasx.mla.decode"):
        out = _absorbed_decode(cfg, p, cache, cache_index, q_nope, q_rope,
                               ckv, k_rope, H, scale)
    out = out.to(x.dtype).reshape(B, S, H * vd)
    return _mla_out(cfg, p, out, rules, n), cache


def _absorbed_decode(cfg, p, cache, idx, q_nope, q_rope, ckv, k_rope, H,
                     scale):
    """One decode step's attention against the compressed cache, this
    step's c_kv and RoPE key written into it first: W_uk absorbed into
    q, W_uv applied after, in f32; (B, 1, H, v_head_dim)."""
    B = q_nope.shape[0]
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    rows = torch.arange(B, device=q_nope.device)
    ckv_c, krope_c = cache["ckv"], cache["k_rope"]
    ckv_c[rows, idx] = ckv[:, 0]
    krope_c[rows, idx] = k_rope[:, 0]

    wkv_b = p["wkv_b"].reshape(cfg.kv_lora_rank, H, nope + vd)
    w_uk = wide(wkv_b[..., :nope])   # (r, H, nope)
    w_uv = wide(wkv_b[..., nope:])   # (r, H, vd)
    # absorb W_uk into q: q_c (B, S=1, H, r)
    q_c = torch.einsum("bshn,rhn->bshr", wide(q_nope), w_uk)
    Skv = ckv_c.shape[1]
    kpos = torch.arange(Skv, dtype=torch.int32, device=q_nope.device)
    valid = (idx + 1)[:, None, None, None]
    scores = (torch.einsum("bshr,bkr->bhsk", q_c, wide(ckv_c))
              + torch.einsum("bshr,bkr->bhsk", wide(q_rope),
                             wide(krope_c))) * scale
    scores = torch.where(kpos[None, None, None, :] < valid, scores,
                         torch.tensor(-1e30, dtype=scores.dtype,
                                      device=scores.device))
    w = torch.softmax(scores, dim=-1)
    o_c = torch.einsum("bhsk,bkr->bshr", w, wide(ckv_c))
    return torch.einsum("bshr,rhv->bshv", o_c, w_uv)


def _mla_out(cfg, p, out: torch.Tensor, rules: MeshRules, n: int
             ) -> torch.Tensor:
    """``wo`` on MLA's attention output of this rank's H/n heads (its
    rows' block); where n is 1 on every head, of which ``wo``'s rows
    still take their block."""
    if n == 1:
        out = _head_block(out, rules)
    return row_parallel_matmul(out, p["wo"], rules,
                               cfg.n_heads * cfg.v_head_dim)
