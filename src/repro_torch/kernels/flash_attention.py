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
against ~16 MB).  :func:`flash_path` picks one of two paths by dtype and
alignment alone, and the wrapper passes it to the kernel:

* ``"mma"`` — f16/bf16 whose operands have 16-byte aligned bases and
  batch, seq and head strides that are multiples of 8 elements:
  ``mma.sync`` tensor-core products with f32 accumulators, P carried as
  two 16-bit terms so bf16 keeps ~16 bits of it;
* ``"simt"`` — f32 (never TF32) and the other 16-bit operands: both
  products on the CUDA cores in f32.

Each path has its compiled ``(block_q, block_k)`` in ``BLOCKS``.

The kernel or its plain version is chosen by the tensors' device: CPU
tensors take ``kernels.ref.flash_attention_ref``; CUDA tensors launch
the kernel or raise.  Nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.dtypes import dtype_name
from . import build
from .ref import flash_attention_ref

# what the library compiles (csrc/flash_attention.cu FLASH_HEAD_DIMS and
# FLASH_<PATH>_BLOCKS): head dims, and each path's (block_q, block_k).
# simt: at the serving prefill's shape (D = 128) 64-row k steps beat
# 32-row ones on an H100 (PERF.md), though only one 113 KB block then
# fits on an SM.  mma: 4 warps of 16 q rows (8 warps, BQ = 128, were no
# faster: PERF.md)
HEAD_DIMS: Tuple[int, ...] = (8, 16, 32, 64, 128)
PATHS: Tuple[str, ...] = ("mma", "simt")
PATH_CODES = {"simt": 0, "mma": 1}  # csrc/flash_attention.cu Path
BLOCKS: Dict[str, Tuple[int, int]] = {"simt": (64, 64), "mma": (64, 64)}
SMEM_BUDGET = 232448  # bytes of shared memory one block may use (227 KB)

_DTYPE_CODES = {torch.float32: 1, torch.float16: 2, torch.bfloat16: 3}

# launches of the kernel in this process, in all, by dtype, and by path
# and dtype ({"mma": {"bfloat16": n}, ...}); plain-version calls never
# count
LAUNCHES = 0
LAUNCHES_BY_DTYPE: Dict[str, int] = {}
LAUNCHES_BY_PATH: Dict[str, Dict[str, int]] = {}
_count_lock = threading.Lock()


def smem_bytes(path: str, d: int) -> int:
    """Shared memory of one block of ``path`` at head dim ``d``.  simt
    stages f32: the transposed q and k tiles and the probability tile,
    each skewed by one column, and the v tile.  mma stages the input
    type: the q tile and two stages each of K and V, rows of max(d, 16)
    elements skewed by 8."""
    if path not in BLOCKS:
        raise ValueError(f"unknown path {path!r}; choose from {PATHS}")
    bq, bk = BLOCKS[path]
    if path == "simt":
        return 4 * (d * (bq + 1) + d * (bk + 1) + bk * d + bk * (bq + 1))
    return 2 * (bq + 4 * bk) * (max(d, 16) + 8)


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, seq, head) element strides of a (B, S, H, D) view; 0 for
    an axis of size 1, whose stride is never used."""
    return tuple(x.stride(i) if x.shape[i] > 1 else 0 for i in range(3))


def flash_path(dtype, d: int, *operands: torch.Tensor) -> str:
    """The path a call of ``dtype`` and head dim ``d`` takes on the card:
    ``"mma"`` for f16/bf16 whose ``operands`` ((B, S, H, D) views: q, k,
    v and the output) all have 16-byte aligned bases and batch, seq and
    head strides that are multiples of 8 elements, else ``"simt"`` (f32,
    and 16-bit operands the mma path's 16-byte copies cannot read).  The
    kernel is told the path; it only refuses operands the path cannot
    read."""
    if dtype not in (torch.float16, torch.bfloat16) or d % 8:
        return "simt"
    for x in operands:
        if x.data_ptr() % 16 or any(s % 8 for s in _strides(x)):
            return "simt"
    return "mma"


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


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_attention").flash_attention_fwd
    # path, dtype, d, bq, bk, q, k, v, o, B, H, Hkv, Sq, Sk, scale,
    # causal, 12 strides (q, k, v, o: batch, seq, head), stream
    fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    path = flash_path(q.dtype, d, q, k, v, o)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _entry()(PATH_CODES[path], _DTYPE_CODES[q.dtype], d,
                      *BLOCKS[path], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), b, h, hkv, sq, sk, scale,
                      int(causal), *_strides(q), *_strides(k), *_strides(v),
                      *_strides(o), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: error {rc} "
                           f"(path={path} B={b} Sq={sq} Sk={sk} H={h} "
                           f"Hkv={hkv} D={d} dtype={q.dtype})")
    with _count_lock:
        LAUNCHES += 1
        name = dtype_name(q.dtype)
        LAUNCHES_BY_DTYPE[name] = LAUNCHES_BY_DTYPE.get(name, 0) + 1
        by_path = LAUNCHES_BY_PATH.setdefault(path, {})
        by_path[name] = by_path.get(name, 0) + 1
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
