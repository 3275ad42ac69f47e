"""Shared building blocks: parameter maker, norms, RoPE, activations.

The counterpart of the reference's ``models/layers.py``.  Norms and
RoPE compute in float32 and cast back to the input's type, as there.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .sharding import MeshRules

# gelu is the tanh approximation, as jax.nn.gelu's default is
ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
       "relu": F.relu}


class Maker:
    """Builds the parameter tree as real tensors on ``device`` (the card
    unless the caller asks for the CPU), drawn from ``generator`` (which
    lives on the same device).  Only the reference's
    ``init`` mode: its ``abstract`` mode (shapes with shardings, for the
    dry-run) comes with the dry-run's port."""

    def __init__(self, mode: str, rules: MeshRules, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        if mode != "init":
            raise NotImplementedError(
                f"Maker mode {mode!r}: the port builds real parameters "
                f"only ('init'); 'abstract' comes with the dry-run slice")
        self.dtype = dtype
        self.generator = generator
        self.device = torch.device(device)

    def param(self, shape: Sequence[int], logical: Sequence[Optional[str]],
              scale: Optional[float] = None, zeros: bool = False,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Normal(0, 1) x ``scale`` (default 1/sqrt(fan_in), fan_in the
        second-to-last dim), drawn in float32 and cast to ``dtype`` (the
        maker's by default); zeros where ``zeros``."""
        shape = tuple(int(s) for s in shape)
        dtype = dtype or self.dtype
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical axes {logical}")
        if zeros:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(1, fan_in))
        arr = torch.randn(shape, generator=self.generator,
                          dtype=torch.float32, device=self.device)
        # scaled in place: one stack of DeepSeek-V3's 256 experts is 15 GB
        # in float32, so a second float32 copy is worth saving
        return arr.mul_(scale).to(dtype)

    def ones(self, shape, logical, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        return torch.ones(shape, dtype=dtype or self.dtype,
                          device=self.device)


# ------------------------------------------------------------------ norms
def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(dt)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5
               ) -> torch.Tensor:
    """Supports OLMo's non-parametric LN (weight=bias=None)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def apply_norm(cfg, x: torch.Tensor, p: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if cfg.nonparametric_ln:
        return layer_norm(x, None, None, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
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
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        rules: MeshRules) -> torch.Tensor:
    """y = x @ w for w row-sharded on the model axis; psum in x.dtype.

    Under a model axis of n > 1 ranks that divides x's features and w's
    rows, this rank takes its 1/n of both, multiplies them with an f32
    accumulator, casts to ``x.dtype`` and all-reduces over the model
    group (in x's dtype, bf16 in the models, not f32: half the payload
    of the dominant tensor-parallel collective); otherwise one matmul."""
    ax = rules.model_axis
    n = rules.axis_size(ax)
    if (rules.mesh is None or n <= 1 or x.ndim != 3 or x.shape[-1] % n
            or w.shape[0] % n):
        return x @ w
    from ..core.distributed import psum, replicated
    group = rules.group(ax)
    f = x.shape[-1] // n
    lo = rules.coordinate(ax) * f
    xl = replicated(x, group)[..., lo:lo + f]
    wl = replicated(w, group)[lo:lo + f]
    part = torch.matmul(xl.float(), wl.float()).to(x.dtype)
    return psum(part, group)


# ------------------------------------------------------------------- MLP
def make_mlp_params(mk: Maker, d: int, ff: int) -> dict:
    return {
        "wi": mk.param((d, ff), ("embed", "model")),
        "wg": mk.param((d, ff), ("embed", "model")),
        "wo": mk.param((ff, d), ("model", "embed")),
    }


def mlp(cfg, p: dict, x: torch.Tensor, rules: MeshRules) -> torch.Tensor:
    act = ACT[cfg.act]
    h = act(x @ p["wg"]) * (x @ p["wi"])
    h = rules.constrain(h, "batch", None, "model")
    return row_parallel_matmul(h, p["wo"], rules)
