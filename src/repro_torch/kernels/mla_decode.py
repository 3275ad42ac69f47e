"""Wrapper of the hand-written MLA absorbed-decode kernel
(``csrc/mla_decode.cu``).

``mla_decode(q_c, q_rope, ckv, k_rope, idx, scale)`` computes one decode
step's attention of multi-head latent attention against the compressed
cache, W_uk already absorbed into q: for each slot b and head h,

    o_c[b, h] = softmax_j(scale * (q_c[b, h] . ckv[b, j]
                                   + q_rope[b, h] . k_rope[b, j])) ckv[b, j]

over the live positions ``j <= idx[b]``, in f32.  q_c ``(B, H, R)`` is
f32 (the absorb's result); q_rope ``(B, H, Dr)``; the cache's ``ckv``
``(B, Skv, R)`` and ``k_rope`` ``(B, Skv, Dr)`` in their stored dtype,
read in place through their strides (their last axis contiguous);
``idx`` ``(B,)`` int32 or int64, each slot's last live position.
Returns o_c ``(B, H, R)`` in q_c's dtype.  It replaces no TPU kernel:
the reference's absorbed decode is plain jnp
(``src/repro/models/attention.py``); ``kernels.ref.mla_decode_ref`` is
the port's plain version of it.

The plain version or the kernel is chosen by the tensors' device: CPU
tensors take :func:`~repro_torch.kernels.ref.mla_decode_ref`; CUDA
tensors launch the kernel or raise.  Nothing falls back.  On the card
:func:`mla_path` picks the path by the cache's dtype alone:

* ``"wgmma"`` — bf16/f16 caches at DeepSeek-V3's widths (R 512, Dr 64,
  ``R``/``ROPE`` below): blocks of 64 heads over a split of the live
  positions, the tensor cores' products with q_c and P carried as two
  16-bit terms each, an f32 online softmax, and a second kernel that
  merges a slot's splits.  Other widths raise.
* ``"simt"`` — f32 caches (tests, reduced models): FP32 FMAs, one block a
  (slot, head), latent widths up to ``SIMT_MAX_R``.

The launch is the operator ``torch.ops.repro_torch.mla_decode``, so a
trace on fake tensors (``launch/dryrun.py``) passes through its fake,
which launches and counts nothing, and ``FlopCounterMode`` counts it by
its registered formula.  Nothing here reads the live lengths on the
host: the blocks read ``idx`` on the device, and the grid is sized from
``Skv``, ``B`` and ``H`` (:func:`splits`).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ..core.dtypes import dtype_name
from . import build
from .ref import mla_decode_ref

# what the library compiles (csrc/mla_decode.cu's MLA_* defines): the
# tensor-core path's latent and RoPE widths, the heads of a block (one
# wgmma M), the cache positions of a tile; the simt path's widest latent
# and widest q
R, ROPE, HEADS, BK = 512, 64, 64, 32
SIMT_MAX_R, SIMT_MAX_DQ = 512, 1024
PATHS: Tuple[str, ...] = ("wgmma", "simt")
_DTYPE_CODES = {torch.float32: 1, torch.float16: 2, torch.bfloat16: 3}
# the split (:func:`splits`): blocks enough for WAVES waves of the card's
# SMs, each over at least MIN_SPLIT positions.  Timed on an H100 (PERF.md
# §6): one slot of 8192 live positions takes 0.56 ms unsplit and 0.03 ms
# in 32 runs of 256; at the benchmark cell's 256 slots (512 blocks) a
# split only adds partials (0.90 ms unsplit, 0.92 in 4 runs, 1.16 in 16)
WAVES = 2
MIN_SPLIT = 256

# launches of the kernel in this process by path and cache dtype
# ({"wgmma": {"bfloat16": n}, ...}); plain-version calls never count
LAUNCHES_BY_PATH: Dict[str, Dict[str, int]] = {}
_count_lock = threading.Lock()


def count_launch(path: str, dtype: torch.dtype) -> None:
    """Add one launch of ``path`` on a cache of ``dtype``."""
    name = dtype_name(dtype)
    with _count_lock:
        by_path = LAUNCHES_BY_PATH.setdefault(path, {})
        by_path[name] = by_path.get(name, 0) + 1


def mla_path(dtype: torch.dtype) -> str:
    """The path a cache of ``dtype`` takes on the card."""
    return "simt" if dtype == torch.float32 else "wgmma"


def splits(skv: int, b: int, h: int, sms: int) -> Tuple[int, int]:
    """(split_len, n_splits) of the wgmma path at ``Skv``, ``B`` and ``H``
    on a card of ``sms`` SMs: the positions are cut into the fewest
    equal runs (a power of two, whole tiles) that give B * ceil(H / 64) *
    n_splits blocks enough for ``WAVES`` waves, no run under
    ``MIN_SPLIT`` positions.  The live lengths are not looked at: a block
    whose run starts past its slot's live length exits at once, and the
    runs are short enough that a slot of any length spreads over the
    card."""
    hg = -(-h // HEADS)
    tiles = -(-skv // BK)
    n = 1
    while b * hg * n < WAVES * sms and -(-tiles // (2 * n)) * BK >= MIN_SPLIT:
        n *= 2
    split = -(-tiles // n) * BK
    return split, -(-skv // split)


def workspace_floats(b: int, h: int, n_splits: int) -> int:
    """f32 partials of the wgmma path: a (slot, head group, split)'s
    running max, sum and unnormalised o; none without a split."""
    if n_splits == 1:
        return 0
    return n_splits * b * -(-h // HEADS) * HEADS * (R + 2)


def _check(q_c, q_rope, ckv, k_rope, idx) -> None:
    """Raise on anything the decode does not take, on every device, so a
    call that passes on the CPU passes the same checks on the card."""
    named = (("q_c", q_c), ("q_rope", q_rope), ("ckv", ckv),
             ("k_rope", k_rope), ("idx", idx))
    for name, x in named:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"mla_decode takes torch tensors ({name})")
        if x.device != ckv.device:
            raise ValueError(f"operands on different devices: {ckv.device} "
                             f"and {x.device} ({name})")
    for name, x in named[:4]:
        if x.ndim != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(x.shape)}")
        if not x.is_floating_point():
            raise ValueError(f"{name} must be floating point, got {x.dtype}")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if ckv.dtype != k_rope.dtype:
        raise ValueError(f"cache dtypes differ: ckv {ckv.dtype}, k_rope "
                         f"{k_rope.dtype}")
    b, h, r = q_c.shape
    skv = ckv.shape[1]
    if (q_rope.shape[:2] != (b, h) or ckv.shape != (b, skv, r)
            or k_rope.shape != (b, skv, q_rope.shape[2])):
        raise ValueError(
            f"shape mismatch: q_c {tuple(q_c.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, k_rope "
            f"{tuple(k_rope.shape)}")
    if idx.shape != (b,) or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be ({b},) int32 or int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if skv == 0 or b == 0 or h == 0:
        raise ValueError("empty decode: B, H and Skv must be positive")


def _card_check(q_c, ckv, k_rope) -> None:
    """What the card's paths take beyond :func:`_check`."""
    if q_c.dtype != torch.float32:
        raise ValueError(f"the kernel takes q_c in float32, got {q_c.dtype}")
    if ckv.dtype not in _DTYPE_CODES:
        raise ValueError(f"no kernel for a {ckv.dtype} cache; it takes "
                         f"{sorted(dtype_name(t) for t in _DTYPE_CODES)}")
    b, h, r = q_c.shape
    dr = k_rope.shape[2]
    if mla_path(ckv.dtype) == "simt":
        if r > SIMT_MAX_R or r + dr > SIMT_MAX_DQ:
            raise ValueError(f"the simt path takes R <= {SIMT_MAX_R} and "
                             f"R + Dr <= {SIMT_MAX_DQ}, got {r} and {dr}")
        if b * h > 2 ** 31 - 1:
            raise ValueError(f"B*H={b * h} exceeds the grid's limit")
        return
    if (r, dr) != (R, ROPE):
        raise ValueError(f"the wgmma path is compiled for R {R} and Dr "
                         f"{ROPE}, got {r} and {dr}")
    # TMA reads the cache in place: 16-byte aligned bases and strides
    for name, x in (("ckv", ckv), ("k_rope", k_rope)):
        if x.data_ptr() % 16 or any(x.stride(i) % 8 for i in (0, 1)):
            raise ValueError(f"{name} must have a 16-byte aligned base and "
                             f"batch and seq strides of whole 16-byte "
                             f"chunks (the cache is read in place), got "
                             f"strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("mla_decode").mla_decode
    # dtype, qc, qr, ckv, kr, idx, idx64, o, ws, B, H, Skv, R, Dr,
    # split_len, n_splits, scale, 10 strides, stream
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_longlong] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::mla_decode", mutates_args=("o",))
def _mla_decode_op(q_c: torch.Tensor, q_rope: torch.Tensor,
                   ckv: torch.Tensor, k_rope: torch.Tensor,
                   idx: torch.Tensor, o: torch.Tensor, scale: float) -> None:
    """The kernel's launch into ``o`` on CUDA operands, as an operator:
    so a trace on fake tensors (the dry-run) passes through it without
    launching or counting (its fake below), and ``FlopCounterMode``
    counts it by the formula below."""
    _launch(q_c, q_rope, ckv, k_rope, idx, o, scale)
    count_launch(mla_path(ckv.dtype), ckv.dtype)


@_mla_decode_op.register_fake
def _(q_c, q_rope, ckv, k_rope, idx, o, scale) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.mla_decode)
def _mla_decode_flops(q_c_shape, q_rope_shape, ckv_shape, k_rope_shape,
                      *args, **kwargs) -> int:
    """The products of ``Counts.attention`` that the operator computes,
    at the padded length it is given: the scores over latent and RoPE
    key and the latent sum, 2 B H Skv (2 R + Dr)."""
    b, h, r = q_c_shape
    return 2 * b * h * ckv_shape[1] * (2 * r + q_rope_shape[2])


def _launch(q_c, q_rope, ckv, k_rope, idx, o, scale: float) -> None:
    b, h, r = q_c.shape
    skv, dr = ckv.shape[1], k_rope.shape[2]
    path = mla_path(ckv.dtype)
    split, n = (skv, 1) if path == "simt" else splits(
        skv, b, h, _sm_count(ckv.device.index))
    nws = workspace_floats(b, h, n) if path == "wgmma" else 0
    ws = torch.empty(nws, device=ckv.device) if nws else None
    with torch.cuda.device(ckv.device):
        stream = torch.cuda.current_stream(ckv.device).cuda_stream
        rc = _entry()(_DTYPE_CODES[ckv.dtype], q_c.data_ptr(),
                      q_rope.data_ptr(), ckv.data_ptr(), k_rope.data_ptr(),
                      idx.data_ptr(), int(idx.dtype == torch.int64),
                      o.data_ptr(), None if ws is None else ws.data_ptr(),
                      b, h, skv, r, dr, split, n, scale,
                      q_c.stride(0), q_c.stride(1), q_rope.stride(0),
                      q_rope.stride(1), o.stride(0), o.stride(1),
                      ckv.stride(0), ckv.stride(1), k_rope.stride(0),
                      k_rope.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode launch failed: error {rc} (path="
                           f"{path} B={b} H={h} Skv={skv} R={r} Dr={dr} "
                           f"dtype={ckv.dtype})")


def mla_decode(q_c: torch.Tensor, q_rope: torch.Tensor, ckv: torch.Tensor,
               k_rope: torch.Tensor, idx: torch.Tensor,
               scale: float) -> torch.Tensor:
    """o_c ``(B, H, R)`` in q_c's dtype of one decode step (module
    docstring); ``idx`` holds each slot's last live position, in
    ``[0, Skv)``."""
    _check(q_c, q_rope, ckv, k_rope, idx)
    if ckv.device.type == "cpu":
        return mla_decode_ref(q_c, q_rope, ckv, k_rope, idx, scale)
    if ckv.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {ckv.device}")
    _card_check(q_c, ckv, k_rope)
    o = torch.empty(q_c.shape, dtype=torch.float32, device=q_c.device)
    # q is read as 16-byte rows: contiguous f32 copies where it is not
    torch.ops.repro_torch.mla_decode(
        q_c.contiguous(), q_rope.to(torch.float32).contiguous(), ckv, k_rope,
        idx.contiguous(), o, float(scale))
    return o

