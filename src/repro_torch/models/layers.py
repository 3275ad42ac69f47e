"""Shared building blocks: parameter maker, norms, RoPE, activations.

The counterpart of the reference's ``models/layers.py``.  Norms and
RoPE compute in float32 and cast back to the input's type, as there
(a float64 model, which the reference has not, computes them in float64:
:func:`wide`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .sharding import (MeshRules, abstract_leaf, block_of, layer_placement,
                       local_shape, require_fake_mode)

# gelu is the tanh approximation, as jax.nn.gelu's default is
ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
       "relu": F.relu}


class Maker:
    """Builds the parameter tree on ``device`` (the card unless the
    caller asks for the CPU), each leaf at the placement
    ``rules.fitted_sharding`` gives it:

    * ``init``: real tensors drawn from ``generator`` (which lives on
      the same device).  A leaf is drawn whole, as it is on one rank, and
      only this rank's block of it is kept (:func:`sharding.place`), so
      the blocks of every rank make up one rank's tree bit for bit; a
      stacked leaf (``stacked=True``, a leading layer dim) is drawn one
      layer at a time, so no rank ever holds a whole stack;
    * ``abstract`` (the dry-run's): fake tensors of the placed shapes
      that carry their placement, drawing nothing; it raises outside an
      active ``FakeTensorMode``;
    * ``placement``: the placements alone (``Placement`` or None), the
      tree a model gathers its leaves by."""

    def __init__(self, mode: str, rules: MeshRules, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        if mode not in ("init", "abstract", "placement"):
            raise ValueError(f"Maker mode {mode!r}: 'init', 'abstract' or "
                             f"'placement'")
        if mode == "abstract":
            require_fake_mode()
        self.mode = mode
        self.rules = rules
        self.dtype = dtype
        self.generator = generator
        self.device = torch.device(device)

    def param(self, shape: Sequence[int], logical: Sequence[Optional[str]],
              scale: Optional[float] = None, zeros: bool = False,
              dtype: Optional[torch.dtype] = None, stacked: bool = False
              ) -> torch.Tensor:
        """Normal(0, 1) x ``scale`` (default 1/sqrt(fan_in), fan_in the
        second-to-last dim), drawn in float32 and cast to ``dtype`` (the
        maker's by default); zeros where ``zeros``."""
        shape = tuple(int(s) for s in shape)
        dtype = self._dtype(dtype)
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical axes {logical}")
        placement = self.rules.fitted_sharding(shape, *logical)
        if self.mode != "init":
            return self._other(shape, dtype, placement)
        if zeros:
            return torch.zeros(local_shape(shape, placement), dtype=dtype,
                               device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(1, fan_in))

        def draw(s):
            # scaled in place: one layer of DeepSeek-V3's 256 experts is
            # 15 GB in float32, so a second float32 copy is worth saving
            return torch.randn(s, generator=self.generator,
                               dtype=torch.float32,
                               device=self.device).mul_(scale)

        if not stacked:
            whole = draw(shape)
            return _kept(whole, block_of(whole, placement), dtype)
        out = torch.empty(local_shape(shape, placement), dtype=dtype,
                          device=self.device)
        layer = layer_placement(placement)
        for i in range(shape[0]):
            out[i].copy_(block_of(draw(shape[1:]), layer))
        return out

    def ones(self, shape, logical, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        dtype = self._dtype(dtype)
        placement = self.rules.fitted_sharding(shape, *logical)
        if self.mode != "init":
            return self._other(shape, dtype, placement)
        return torch.ones(local_shape(shape, placement), dtype=dtype,
                          device=self.device)

    def _dtype(self, dtype: Optional[torch.dtype]) -> torch.dtype:
        """A leaf's dtype: its own (the float32 leaves) or the maker's; a
        float64 model holds every leaf in float64, drawn as the float32
        model's, so the two start from the same values."""
        if self.dtype == torch.float64:
            return torch.float64
        return dtype or self.dtype

    def _other(self, shape, dtype, placement):
        if self.mode == "placement":
            return placement
        return abstract_leaf(shape, dtype, self.device, placement)


def _kept(whole: torch.Tensor, block: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """``block`` of a whole draw in ``dtype``, in storage of its own
    where it is a part of the draw, so the draw can be freed."""
    if block is whole:
        return whole.to(dtype)
    return torch.empty(block.shape, dtype=dtype,
                       device=block.device).copy_(block)


# ------------------------------------------------------------------ norms
def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the stack computes its sums in: float32, or
    float64 in a float64 model (a yardstick of the float32 runs)."""
    return x.to(torch.promote_types(torch.float32, x.dtype))


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = wide(x)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * wide(weight)
    return y.to(dt)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """Supports OLMo's non-parametric LN (weight=bias=None)."""
    dt = x.dtype
    xf = wide(x)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * wide(weight)
    if bias is not None:
        y = y + wide(bias)
    return y.to(dt)


def apply_norm(cfg, x: torch.Tensor, p: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if cfg.nonparametric_ln:
        return layer_norm(x, None, None, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                dtype: torch.dtype = torch.float32,
                inv_freq: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2), in
    ``dtype`` (float32; float64 in a float64 model).  ``inv_freq``
    (head_dim//2,) replaces the plain ``theta**(-2i/head_dim)`` (a
    config's ``rope_inv_freq``: YaRN's under DeepSeek-V3)."""
    if inv_freq is None:
        half = head_dim // 2
        exps = torch.arange(half, dtype=dtype,
                            device=positions.device) / half
        freqs = 1.0 / (theta ** exps)
    else:
        freqs = inv_freq.to(dtype=dtype, device=positions.device)
    ang = positions.to(dtype)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2).  Rotates the
    concatenated halves, in float32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:        # (S, D/2) -> (1, S, 1, D/2)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.ndim == 3:      # (B, S, D/2) -> (B, S, 1, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = wide(x1), wide(x2)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def model_replicated(x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    """``x``, held alike by every model rank, entering a region where
    each uses its model block of the weights (the Megatron column
    entry): the identity, whose gradient is all-reduced over the model
    group, since each rank's part of it comes from its block alone."""
    from ..core.distributed import replicated
    return replicated(x, rules.group(rules.model_axis))


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        rules: MeshRules, features: int) -> torch.Tensor:
    """y = x @ w for w row-sharded on the model axis; psum in x.dtype.

    ``features`` is the global width of x's last dim (w's rows).  Where
    the model axis splits it (``rules.model_ways(features) > 1``), x and
    w are this rank's blocks of it: they are multiplied with an f32
    accumulator, cast to ``x.dtype`` and all-reduced over the model
    group (in x's dtype, bf16 in the models, not f32: half the payload
    of the dominant tensor-parallel collective, the reference's
    ``BF16_ROW_PSUM``); otherwise both are whole and it is one matmul."""
    if rules.model_ways(features) == 1:
        return x @ w
    from ..core.distributed import psum
    part = torch.matmul(wide(x), wide(w)).to(x.dtype)
    return psum(part, rules.group(rules.model_axis))


# ------------------------------------------------------------------- MLP
def make_mlp_params(mk: Maker, d: int, ff: int) -> dict:
    return {
        "wi": mk.param((d, ff), ("embed", "model")),
        "wg": mk.param((d, ff), ("embed", "model")),
        "wo": mk.param((ff, d), ("model", "embed")),
    }


def mlp(cfg, p: dict, x: torch.Tensor, rules: MeshRules,
        ff: Optional[int] = None) -> torch.Tensor:
    """The gated MLP of width ``ff`` (default ``cfg.d_ff``).  Where the
    model axis splits ``ff``, ``wg``/``wi`` are this rank's column
    blocks, so the hidden ``h`` is its (B, S, ff/n) block, and ``wo``'s
    rows finish it in :func:`row_parallel_matmul`."""
    ff = ff or cfg.d_ff
    if rules.model_ways(ff) > 1:
        x = model_replicated(x, rules)
    act = ACT[cfg.act]
    h = act(x @ p["wg"]) * (x @ p["wi"])
    h = rules.constrain(h, "batch", None, "model")
    return row_parallel_matmul(h, p["wo"], rules, ff)
