"""AdamW with a cosine schedule, global-norm clip, blockwise int8 moment
states, and int8 error-feedback gradient compression for the data-
parallel all-reduce.

The counterpart of the reference's ``optim/adamw.py``.  Trees are
nested dicts of tensors (``repro_torch.tree``); an update builds new
tensors under ``torch.no_grad()`` and returns new trees, as the
reference's functional update does, or, donated (the train loop's, as
the reference's ``run`` jits its step with ``donate_argnums=(0, 1)``),
writes each leaf's new values into the tensors that held the old ones.  The scalar arithmetic (schedule,
bias corrections, clip scale) runs in float32 tensors on the step's
device, as the reference's runs in float32 arrays.

Under a mesh each parameter, its gradient and its f32 moments are held
at the parameter's placement (``models/sharding.py``): the update is
elementwise, so each rank updates its blocks, and the clip's global norm
sums each leaf's squares over the ranks that hold its blocks.  The int8
moment states are on no train path and are held whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..core.distributed import all_reduce
from ..models.layers import wide
from ..tree import tree_flatten, tree_get, tree_map, tree_unflatten

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params: Any) -> dict:
    """m/v in f32 (f64 beside f64 parameters) beside each parameter (of
    its held shape: this rank's block under a mesh), step an int32
    scalar."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=wide(p).dtype, device=p.device)
    device = tree_flatten(params)[1][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(params: Any) -> dict:
    """The shape-only twin of :func:`init_state` for the dry-run: fake
    f32 moments beside each (fake) parameter, carrying its placement,
    and an int32 scalar step; inside an active ``FakeTensorMode``."""
    from ..models.sharding import abstract_leaf, global_shape, placement_of

    def leaf(p):
        return abstract_leaf(global_shape(p), torch.float32, p.device,
                             placement_of(p))
    device = tree_flatten(params)[1][0].device
    return {"m": tree_map(leaf, params), "v": tree_map(leaf, params),
            "step": abstract_leaf((), torch.int32, device)}


def state_placements(placements: Any) -> dict:
    """The placements of :func:`init_state`'s tree: each moment at its
    parameter's, the step whole."""
    return {"m": placements, "v": placements, "step": None}


@torch.no_grad()
def global_norm(tree: Any, placements: Any = None) -> torch.Tensor:
    """The norm of the whole gradient.  With ``placements`` (the tree's,
    under a mesh) the squares of the leaves sharded on the same axes are
    summed locally, then over those axes' ranks, so each element counts
    once, a replicated leaf's too."""
    from ..models.sharding import sharded_axes
    leaves = tree_flatten(tree)[1]
    places = ([None] * len(leaves) if placements is None
              else tree_flatten(placements)[1])
    by_axes = {}
    for g, pl in zip(leaves, places):
        sq = torch.sum(torch.square(wide(g)))
        key = (sharded_axes(pl), pl and pl.mesh)
        by_axes[key] = sq if key not in by_axes else by_axes[key] + sq
    total = None
    for (axes, mesh), sq in by_axes.items():
        for ax in axes:
            sq = all_reduce(sq, mesh.get_group(ax))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (wide(g) * scale).to(g.dtype)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float, placements: Any = None
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads, placements)
    scale = _clip_scale(max_norm, norm)
    return tree_map(lambda g: _clipped(g, scale), grads), norm


def _bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    stepf = step.to(torch.float32)
    return 1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf


def _leaves_like(params: Any, *trees):
    """Each tree's entries at the paths of ``params``' leaves (an entry
    may itself be a dict, as an int8 moment's {q, scale} is)."""
    paths, flat_p = tree_flatten(params)
    return paths, flat_p, [[tree_get(t, p) for p in paths] for t in trees]


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                  placements: Any = None, donate: bool = False
                  ) -> Tuple[Any, dict, dict]:
    """One AdamW step (``placements``: the parameters', under a mesh).
    Returns (new_params, new_state, metrics).  Each leaf's gradient is
    clipped by the global norm, then its new parameter and moments are
    computed; with ``donate`` they are written into ``params``' and
    ``state``'s tensors before the next leaf's (so one leaf's
    temporaries are alive at a time, and no second tree), the step count
    too, and ``params`` and ``state`` themselves are returned, bitwise
    what the undonated step returns."""
    gnorm = global_norm(grads, placements)
    scale = _clip_scale(cfg.grad_clip, gnorm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = _bias_corrections(cfg, step)

    def upd(p, g, m, v):
        gf = wide(_clipped(g, scale))
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            wide(p)
        p2 = wide(p) - lr * delta
        return p2.to(p.dtype), m2, v2

    paths, flat_p, (flat_g, flat_m, flat_v) = _leaves_like(
        params, grads, state["m"], state["v"])
    metrics = {"grad_norm": gnorm, "lr": lr}
    if donate:
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            for old, new in zip((p, m, v), upd(p, g, m, v)):
                old.copy_(new)
        state["step"].copy_(step)
        return params, state, metrics
    out = [upd(p, g, m, v) for p, g, m, v
           in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(paths, [o[0] for o in out])
    new_m = tree_unflatten(paths, [o[1] for o in out])
    new_v = tree_unflatten(paths, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics


# ----------------------------------------------------- int8 moment states
# Blockwise (128-element) int8 quantization of AdamW's m/v moments: the
# 8-bit-optimizer trick that shrinks state from 8 to ~2.06 bytes a
# parameter.
QBLOCK = 128


def quantize_blockwise(x: torch.Tensor):
    """f32 -> (int8 payload, f32 per-block scales)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % QBLOCK))
    blocks = flat.reshape(-1, QBLOCK)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                    ).to(torch.int8)
    return q, scale.float()


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def init_state_int8(params: Any) -> dict:
    def zeros_q(p):
        n = max(1, -(-p.numel() // QBLOCK))
        return {"q": torch.zeros((n, QBLOCK), dtype=torch.int8,
                                 device=p.device),
                "scale": torch.zeros((n,), dtype=torch.float32,
                                     device=p.device)}
    device = tree_flatten(params)[1][0].device
    return {"m": tree_map(zeros_q, params), "v": tree_map(zeros_q, params),
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "int8": True}


@torch.no_grad()
def apply_updates_int8(cfg: AdamWConfig, params: Any, grads: Any,
                       state: dict) -> Tuple[Any, dict, dict]:
    """AdamW with int8 moments: dequantize -> update -> requantize."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = _bias_corrections(cfg, step)

    def upd(p, g, mq, vq):
        gf = g.float()
        m = dequantize_blockwise(mq["q"], mq["scale"], p.shape)
        # v is stored as sqrt(v): halves its dynamic range so blockwise
        # linear int8 holds it without zero-flushing small entries
        v = dequantize_blockwise(vq["q"], vq["scale"], p.shape) ** 2
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p2 = (p.float() - lr * delta).to(p.dtype)
        q_m, s_m = quantize_blockwise(m2)
        q_v, s_v = quantize_blockwise(torch.sqrt(v2))
        return p2, {"q": q_m, "scale": s_m}, {"q": q_v, "scale": s_v}

    paths, flat_p, (flat_g, flat_m, flat_v) = _leaves_like(
        params, grads, state["m"], state["v"])
    out = [upd(p, g, m, v) for p, g, m, v
           in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(paths, [o[0] for o in out])
    new_m = tree_unflatten(paths, [o[1] for o in out])
    new_v = tree_unflatten(paths, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step, "int8": True}, \
        {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------------------ compression
def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 quantization: returns (q, scale, new_err).
    The residual (g + err - dequant(q)) is carried to the next step, so
    compression bias vanishes in expectation."""
    gf = g.float() + err
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compressed_psum(grads: Any, err_state: Any, group
                    ) -> Tuple[Any, Any]:
    """Data-parallel mean with an int8 payload and error feedback: each
    rank quantizes its gradient, the dequantized values are all-reduced
    over ``group`` (a mesh axis's process group) and divided by its
    size.  Returns (mean gradients, new error state)."""
    n = dist.get_world_size(group)
    paths, flat_g = tree_flatten(grads)
    out_g, out_e = [], []
    for g, e in zip(flat_g, (tree_get(err_state, p) for p in paths)):
        q, scale, new_e = compress_int8(g, e)
        out_g.append(all_reduce(decompress_int8(q, scale), group) / n)
        out_e.append(new_e)
    return tree_unflatten(paths, out_g), tree_unflatten(paths, out_e)
