"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` computes causal (or full) GQA attention for
q ``(B, Sq, H, D)`` and k/v ``(B, Sk, Hkv, D)``; ``flash_attention_bhsd``
takes the reference kernel's own layout, q ``(BH, Sq, D)`` and k/v
``(BHkv, Sk, D)``.  Both replace the reference's TPU kernel
``kernels/flash_attention.py`` (``_flash_kernel`` launched by
``flash_attention_bhsd``, and the layout wrapper ``flash_attention``)
and compute what it computes: f32 scores and online softmax, masked
scores -1e30, the causal mask top-left aligned, the output in q's type.

The (B, S, H, D) wrapper does not transpose: the kernel reads q, k and v
and writes o in place through their strides, so any layout whose last
axis is contiguous is taken as it is (``flash_attention_bhsd`` passes
permuted views of its operands).  There is no pad copy either: ragged
rows are masked loads.

What bounds it on the card: at the serving path's prefill (B*H = 16,
S = 1024, D = 128, causal) it is bound by operations (~4.3 GFLOP
against ~16 MB).  This first kernel runs both products on the CUDA cores
in f32 (so f32 never takes TF32); the tensor cores are later work.

The kernel or its plain version is chosen by the tensors' device: CPU
tensors take ``kernels.ref.flash_attention_ref``; CUDA tensors launch
the kernel or raise.  Nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.dtypes import dtype_name
from . import build
from .ref import flash_attention_ref

# shapes compiled into the library (csrc/flash_attention.cu dispatch)
HEAD_DIMS: Tuple[int, ...] = (8, 16, 32, 64, 128)
BLOCK_Q = 64   # q rows per block
# k rows per step: at the serving prefill's shape (D = 128) 64-row steps
# beat 32-row ones on an H100 (PERF.md), though only one 113 KB block
# then fits on an SM
BLOCK_K = 64
SMEM_BUDGET = 232448  # bytes of shared memory one block may use (227 KB)

_DTYPE_CODES = {torch.float32: 1, torch.float16: 2, torch.bfloat16: 3}

# launches of the kernel in this process, in all and by dtype
# (plain-version calls never count)
LAUNCHES = 0
LAUNCHES_BY_DTYPE: Dict[str, int] = {}
_count_lock = threading.Lock()


def smem_bytes(d: int) -> int:
    """Shared memory of one block (f32): the transposed q and k tiles and
    the probability tile, each skewed by one column, and the v tile."""
    bq, bk = BLOCK_Q, BLOCK_K
    return 4 * (d * (bq + 1) + d * (bk + 1) + bk * d + bk * (bq + 1))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take — on every device, so
    a call that passes on the CPU passes on the card too."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"flash_attention takes torch tensors ({name})")
        if x.ndim != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got "
                             f"{tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"operands on different devices: {q.device} "
                             f"and {x.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"operand dtypes differ: {q.dtype} and "
                             f"{x.dtype}")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes "
                         f"{sorted(dtype_name(t) for t in _DTYPE_CODES)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} outside the compiled table "
                         f"{HEAD_DIMS}")
    if k.shape[1] == 0:
        raise ValueError("no keys: Sk = 0")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the grid's y limit 65535")
    if max(q.shape[1], k.shape[1]) >= 2 ** 31:
        raise ValueError("sequence lengths must fit in 32-bit ints")


def _entry():
    fn = build.load("flash_attention").flash_attention_fwd
    # dtype, d, q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
    # 12 strides (q, k, v, o: batch, seq, head), stream
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bshd_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    return x.stride(0), x.stride(1), x.stride(2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: Optional[torch.Tensor], causal: bool,
            scale: Optional[float]) -> torch.Tensor:
    """Shared body: q (B, Sq, H, D), k/v (B, Sk, Hkv, D) views of any
    strides with a contiguous last axis; the kernel writes ``out`` (a
    (B, Sq, H, D) view) or a new contiguous tensor."""
    global LAUNCHES
    d = q.shape[3]
    _check(q, k, v)
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        o = flash_attention_ref(q, k, v, causal=causal, scale=scale)
        if out is None:
            return o
        out.copy_(o)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {q.device}")
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    o = out if out is not None else torch.empty_like(
        q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(_DTYPE_CODES[q.dtype], d, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, hkv,
                      sq, sk, scale, int(causal), *_bshd_strides(q),
                      *_bshd_strides(k), *_bshd_strides(v),
                      *_bshd_strides(o), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: error {rc} "
                           f"(B={b} Sq={sq} Sk={sk} H={h} Hkv={hkv} D={d} "
                           f"dtype={q.dtype})")
    with _count_lock:
        LAUNCHES += 1
        name = dtype_name(q.dtype)
        LAUNCHES_BY_DTYPE[name] = LAUNCHES_BY_DTYPE.get(name, 0) + 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, Hkv, D) with H % Hkv == 0 (GQA).
    Returns (B, Sq, H, D) in q's type.  ``scale`` defaults to D**-0.5."""
    return _attend(q, k, v, None, causal, scale)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The reference kernel's layout: q (BH, Sq, D); k/v (BHkv, Sk, D)
    with BH % BHkv == 0, row b reading kv row b // (BH / BHkv)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.ndim != 3:
            raise ValueError(f"{name} must be a 3-D tensor (BH, S, D)")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    # (BH, S, D) seen as (1, S, BH, D): the strides do the transpose
    view = lambda x: x.permute(1, 0, 2)[None]
    _attend(view(q), view(k), view(v), view(out), causal, scale)
    return out
