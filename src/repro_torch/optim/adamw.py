"""AdamW with a cosine schedule, global-norm clip, blockwise int8 moment
states, and int8 error-feedback gradient compression for the data-
parallel all-reduce.

The counterpart of the reference's ``optim/adamw.py``.  Trees are
nested dicts of tensors (``repro_torch.tree``); an update builds new
tensors under ``torch.no_grad()`` and returns new trees, as the
reference's functional update does.  The scalar arithmetic (schedule,
bias corrections, clip scale) runs in float32 tensors on the step's
device, as the reference's runs in float32 arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..core.distributed import all_reduce
from ..tree import tree_flatten, tree_get, tree_map, tree_unflatten

# what the shape-only state needs
DRY_RUN = ("shape-only optimizer state comes with the dry-run slice "
           "(launch/dryrun.py, abstract mode)")


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
    """m/v in f32 beside each parameter, step an int32 scalar."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_flatten(params)[1][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(params: Any) -> dict:
    raise NotImplementedError(DRY_RUN)


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    total = None
    for g in tree_flatten(tree)[1]:
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _bias_corrections(cfg: AdamWConfig, step: torch.Tensor):
    stepf = step.to(torch.float32)
    return 1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf


def _leaves_like(params: Any, *trees):
    """Each tree's entries at the paths of ``params``' leaves (an entry
    may itself be a dict, as an int8 moment's {q, scale} is)."""
    paths, flat_p = tree_flatten(params)
    return paths, flat_p, [[tree_get(t, p) for p in paths] for t in trees]


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: dict
                  ) -> Tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = _bias_corrections(cfg, step)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        p2 = p.float() - lr * delta
        return p2.to(p.dtype), m2, v2

    paths, flat_p, (flat_g, flat_m, flat_v) = _leaves_like(
        params, grads, state["m"], state["v"])
    out = [upd(p, g, m, v) for p, g, m, v
           in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(paths, [o[0] for o in out])
    new_m = tree_unflatten(paths, [o[1] for o in out])
    new_v = tree_unflatten(paths, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
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
