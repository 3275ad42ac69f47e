"""Plain PyTorch versions of the hand-written kernels.

They compute the same functions as the CUDA kernels in ``csrc/`` with
the same accumulation types.  The CPU tests use them, the wrappers take
them for tensors that lie on the CPU, and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.dtypes import accumulator_dtype

# the GEMM epilogue's activations (the reference's kernels/matmul.py
# ACTIVATIONS): gelu is the tanh approximation, as jax.nn.gelu's
# default is; silu is x * sigmoid(x)
ACTIVATIONS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def _epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor],
              activation: Optional[str]) -> torch.Tensor:
    if bias is not None:
        acc = acc + bias.to(acc.dtype)
    return ACTIVATIONS[activation](acc)


def batched_contract_ref(a: torch.Tensor, b: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None,
                         bias: Optional[torch.Tensor] = None,
                         activation: Optional[str] = None) -> torch.Tensor:
    """``c[g] = act(sum_s a[g, s] @ b[g, s] + bias)`` for a ``(G, S, M,
    K)`` and b ``(G, S, K, N)``, accumulated in float64 for float64 and
    float32 otherwise, bias ``(N,)`` added and the activation applied in
    that type, then cast to ``out_dtype`` (default: a's dtype)."""
    acc = accumulator_dtype(a.dtype)
    out = torch.einsum("gsmk,gskn->gmn", a.to(acc), b.to(acc))
    return _epilogue(out, bias, activation).to(out_dtype or a.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(a @ b + bias)`` for 2-D operands of one dtype, in the
    accumulator type as above (the reference's ``matmul_ref``)."""
    acc = accumulator_dtype(a.dtype)
    out = _epilogue(a.to(acc) @ b.to(acc), bias, activation)
    return out.to(out_dtype or a.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash kernel (the reference's
    ``flash_attention_ref``).  q: (B, Sq, H, D); k/v (B, Sk, Hkv, D).
    f32 scores, masked scores -1e30 (causal: top-left aligned), softmax
    and output in q's type."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None, None, None], s,
                        torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
