"""Attention: GQA (with qk-norm), cross-attention, KV caches for serving,
and query-chunked computation for long prefills.

The counterpart of the GQA part of the reference's
``models/attention.py``.  Softmax/score math in f32; weights and
activations in the config dtype.  MLA (DeepSeek) is not ported yet
(ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .layers import Maker, apply_rope, rms_norm, rope_angles, row_parallel_matmul
from .sharding import MeshRules

DEFAULT_Q_CHUNK = 1024

# Attention backend for train/prefill self-attention:
#   "sdpa"  — chunked einsum attention in plain torch (the reference's
#             "xla" backend)
#   "flash" — the hand-written flash-attention kernel (the reference's
#             "pallas", its TPU target; the reference's _FLASH_INTERPRET
#             = False is that setting on a real TPU).  On CPU tensors the
#             kernel's plain version runs.
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
    qf = q.reshape(B, Sq, Hkv, G, Dk).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale

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
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(v.dtype)


def _sdpa_chunked(q, k, v, qpos, kpos, *, causal, scale, kv_valid=None,
                  chunk=DEFAULT_Q_CHUNK):
    """Query-chunked SDPA: O(chunk * Skv) live scores instead of
    O(Sq * Skv) — the long-prefill memory saver."""
    B, Sq = q.shape[0], q.shape[1]
    if Sq <= chunk or Sq % chunk != 0:
        return _sdpa(q, k, v, qpos=qpos, kpos=kpos, causal=causal,
                     scale=scale, kv_valid=kv_valid)
    outs = []
    for i in range(Sq // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        pi = qpos[sl] if qpos.ndim == 1 else qpos[:, sl]
        outs.append(_sdpa(q[:, sl], k, v, qpos=pi, kpos=kpos, causal=causal,
                          scale=scale, kv_valid=kv_valid))
    return torch.cat(outs, dim=1)


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
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    kv_src = kv_input if kv_input is not None else x
    Skv_in = kv_src.shape[1]

    if cache is not None and kv_input is not None:
        # cross-attention decode: K/V were projected once at prefill
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        k = (kv_src @ p["wk"]).reshape(B, Skv_in, Hkv, hd)
        v = (kv_src @ p["wv"]).reshape(B, Skv_in, Hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if kv_input is None:  # RoPE only for self-attention
            cos, sin = rope_angles(positions, hd, cfg.rope_theta)
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

    if (ATTENTION_BACKEND == "flash" and cache is None
            and kv_input is None and kv_valid is None):
        from ..kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal=causal_eff, scale=scale)
    else:
        out = _sdpa_chunked(q, k, v, qpos=qpos, kpos=kpos,
                            causal=causal_eff, scale=scale,
                            kv_valid=kv_valid, chunk=q_chunk)
    y = row_parallel_matmul(out.reshape(B, S, H * hd), p["wo"], rules)
    return y, new_cache
