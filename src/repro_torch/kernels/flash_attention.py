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
axis is contiguous, whose bases are 16-byte aligned and whose batch, seq
and head strides are whole 16-byte chunks is taken as it is
(``flash_attention_bhsd`` passes permuted views of its operands).  An
operand off that (:func:`operand_staging` says which) is first copied
by :func:`stage` into one contiguous tensor; a staged output is written
there and copied into the caller's.  There is no pad copy: ragged rows
are masked loads.

What bounds it on the card: at the serving path's prefill (B*H = 16,
S = 1024, D = 128, causal) it is bound by operations (~4.3 GFLOP
against ~16 MB).  :func:`flash_path` picks one of two paths by dtype
alone, and the wrapper passes it to the kernel:

* ``"mma"`` — f16/bf16: ``mma.sync`` tensor-core products with f32
  accumulators, P carried as two 16-bit terms so bf16 keeps ~16 bits of
  it;
* ``"simt"`` — f32 (never TF32): both products as FP32 FMAs on the CUDA
  cores, register tiles read with 16-byte shared-memory loads.

Each path has its compiled ``(block_q, block_k)`` in ``BLOCKS``.

The kernel or its plain version is chosen by the tensors' device: CPU
tensors take ``kernels.ref.flash_attention_ref``; CUDA tensors launch
the kernel or raise.  Nothing falls back.  On the card the launch is the
operator ``torch.ops.repro_torch.flash_attention_fwd`` (it stages,
launches and counts), so a trace on fake tensors (``launch/dryrun.py``)
passes through its fake, which launches and counts nothing, and
``FlopCounterMode`` counts it by its registered formula.  The kernel has no backward
(neither has the reference's Pallas kernel): on the card a call whose
inputs require grad, with grad mode on, raises (``models.attention``
sends training through its plain chunked path instead).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ..core.dtypes import dtype_name
from . import build
from .ref import flash_attention_ref

# what the library compiles (csrc/flash_attention.cu FLASH_HEAD_DIMS and
# FLASH_<PATH>_BLOCKS): head dims, and each path's (block_q, block_k).
# simt: 4 warps of 16 q rows and 32-key steps, so two 108 KB blocks fit
# an SM (tools/flash_simt_sweep.py times the other blocks: PERF.md).
# mma: 4 warps of 16 q rows (8 warps, BQ = 128, were no faster: PERF.md)
HEAD_DIMS: Tuple[int, ...] = (8, 16, 32, 64, 80, 128)
PATHS: Tuple[str, ...] = ("mma", "simt")
PATH_CODES = {"simt": 0, "mma": 1}  # csrc/flash_attention.cu Path
BLOCKS: Dict[str, Tuple[int, int]] = {"simt": (64, 32), "mma": (64, 64)}
SMEM_BUDGET = 232448  # bytes of shared memory one block may use (227 KB)
# simt blocks an SM holds at every compiled head dim (108 KB each at
# D = 128 of the SM's 228 KB; test_compiled_blocks_fit_shared_memory)
SIMT_BLOCKS_PER_SM = 2
# the dtypes the library compiles (f64 has no path)
DTYPES: Tuple[torch.dtype, ...] = (torch.float32, torch.float16,
                                   torch.bfloat16)


def shape_key(d: int, causal: bool) -> str:
    """The ledger's tag of a call at head dim ``d``: ``"d80,causal"`` or
    ``"d64,full"``."""
    return f"d{d},{'causal' if causal else 'full'}"


def smem_bytes(path: str, d: int) -> int:
    """Shared memory of one block of ``path`` at head dim ``d``.  simt
    stages f32: the q tile and two stages of K, rows skewed by 4
    elements, two stages of V, and the probability tile, rows skewed by
    8.  mma stages the input type: the q tile and two stages each of K
    and V, rows of max(d, 16) elements skewed by 8."""
    if path not in BLOCKS:
        raise ValueError(f"unknown path {path!r}; choose from {PATHS}")
    bq, bk = BLOCKS[path]
    if path == "simt":
        return 4 * ((bq + 2 * bk) * (d + 4) + 2 * bk * d + bq * (bk + 8))
    return 2 * (bq + 4 * bk) * (max(d, 16) + 8)


def simt_split(b: int, h: int, sq: int, causal: bool, sms: int) -> bool:
    """Whether a causal f32 call of ``b * h`` heads and ``sq`` q rows on
    a card of ``sms`` SMs splits each q-tile's keys over two blocks (the
    kernel combines them): when its tiles are fewer than two waves of
    the blocks the card holds at once.  Fewer tiles than that cannot be
    balanced by taking the heaviest first, and the q-tile that needs
    every key would end the call alone."""
    tiles = b * h * -(-sq // BLOCKS["simt"][0])
    return causal and tiles < 2 * SIMT_BLOCKS_PER_SM * sms


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, seq, head) element strides of a (B, S, H, D) view; 0 for
    an axis of size 1, whose stride is never used."""
    return tuple(x.stride(i) if x.shape[i] > 1 else 0 for i in range(3))


def flash_path(dtype) -> str:
    """The path a call of ``dtype`` takes on the card: ``"mma"`` for
    f16/bf16, ``"simt"`` for f32, whatever the layout
    (:func:`operand_staging` says which operands are staged first).  The
    kernel is told the path; it only refuses operands the path cannot
    read."""
    return "mma" if dtype in (torch.float16, torch.bfloat16) else "simt"


def operand_staging(*operands: torch.Tensor) -> Tuple[bool, ...]:
    """Whether each of ``operands`` ((B, S, H, D) views: q, k, v and the
    output) goes through a :func:`stage` copy: both paths read and write
    16 bytes at a time, so an operand whose base is off 16 bytes, or
    whose batch, seq or head stride is not a whole number of 16-byte
    chunks (8 elements in 16 bits, 4 in f32), is one the kernel cannot
    read or write in place."""
    return tuple(x.data_ptr() % 16 != 0
                 or any(s % (16 // x.element_size()) for s in _strides(x))
                 for x in operands)


def stage(x: torch.Tensor) -> torch.Tensor:
    """One contiguous copy of ``x`` in a fresh (16-byte aligned)
    buffer."""
    return torch.empty_like(x, memory_format=torch.contiguous_format
                            ).copy_(x)


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
    if q.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes "
                         f"{sorted(dtype_name(t) for t in DTYPES)}")
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
    # path, dtype, d, bq, bk, q, k, v, o, ws, counts, B, H, Hkv, Sq, Sk,
    # scale, causal, 12 strides (q, k, v, o: batch, seq, head), stream
    return build.bind("flash_attention", "flash_attention_fwd",
                      [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
                      + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
                      + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: Optional[torch.Tensor], causal: bool,
            scale: Optional[float]) -> torch.Tensor:
    """Shared body: q (B, Sq, H, D), k/v (B, Sk, Hkv, D) views of any
    strides with a contiguous last axis; the kernel writes ``out`` (a
    (B, Sq, H, D) view) or a new contiguous tensor.  Operands the kernel
    cannot read in place are staged on every device, so the CPU tests
    cover the staging and the write-back too."""
    d = q.shape[3]
    _check(q, k, v)
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for tensors on {q.device}")
    on_card = q.device.type == "cuda"
    if on_card and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention_fwd has no backward (nor has the reference's "
            "Pallas kernel): call it on tensors that do not require grad, "
            "or under torch.no_grad()")
    o = out if out is not None else torch.empty_like(
        q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    if on_card:
        torch.ops.repro_torch.flash_attention_fwd(q, k, v, o, causal, scale)
    else:
        _with_staging(q, k, v, o, lambda qs, ks, vs, os_, _: os_.copy_(
            flash_attention_ref(qs, ks, vs, causal=causal, scale=scale)))
    return o


def _with_staging(q, k, v, o, run) -> None:
    """``run(q, k, v, o, staged)`` on operands the kernel can read in
    place: a :func:`stage` copy of each one it cannot, a staged output
    copied back into ``o``; ``staged`` says whether any was staged."""
    staging = operand_staging(q, k, v, o)
    qs, ks, vs = (stage(x) if s else x
                  for x, s in zip((q, k, v), staging))
    os_ = torch.empty_like(o, memory_format=torch.contiguous_format) \
        if staging[3] else o
    run(qs, ks, vs, os_, any(staging))
    if staging[3]:
        o.copy_(os_)


@torch.library.custom_op("repro_torch::flash_attention_fwd",
                         mutates_args=("o",))
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, causal: bool, scale: float
                         ) -> None:
    """The kernel's launch into ``o`` on CUDA operands, as an operator:
    so a trace on fake tensors (the dry-run) passes through it without
    launching or counting (its fake below), and ``FlopCounterMode``
    counts it by the formula below."""
    _with_staging(q, k, v, o, lambda qs, ks, vs, os_, staged: _launch(
        qs, ks, vs, os_, causal, scale, staged))


@_flash_attention_fwd.register_fake
def _(q, k, v, o, causal, scale) -> None:
    return None


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_flops(q_shape, k_shape, v_shape, o_shape, *args,
                 **kwargs) -> int:
    """What ``FlopCounterMode`` counts for ``scaled_dot_product_attention``
    at the same shapes: both products over the full Sq x Sk, 4 B H Sq Sk
    D, causal or not (the reference's count is XLA's of its einsums,
    unmasked too)."""
    b, sq, h, d = q_shape
    return 4 * b * h * sq * k_shape[1] * d


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, causal: bool, scale: float,
            staged: bool) -> None:
    """The kernel's launch on CUDA operands it can read in place, counted
    in the ledger with its :func:`shape_key` and, where any operand was
    staged, ``"staged"``; a :func:`simt_split` call gets its partials'
    workspace and zeroed finish counts."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    path = flash_path(q.dtype)
    ws = counts = None
    if path == "simt" and simt_split(b, h, sq, causal,
                                     build._sm_count(q.device.index)):
        bq = BLOCKS["simt"][0]
        tiles = b * h * -(-sq // bq)
        ws = torch.empty(2 * tiles * bq * (d + 2), device=q.device)
        counts = torch.zeros(tiles, device=q.device, dtype=torch.int32)
    shape = shape_key(d, causal)
    build.launch(
        _entry(), q.device, PATH_CODES[path], build._DTYPE_CODES[q.dtype], d,
        *BLOCKS[path], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), None if ws is None else ws.data_ptr(),
        None if counts is None else counts.data_ptr(), b, h, hkv, sq, sk,
        scale, int(causal), *_strides(q), *_strides(k), *_strides(v),
        *_strides(o),
        key=("flash", path, q.dtype, ("staged", shape) if staged
             else (shape,)),
        details=lambda: (f"path={path} B={b} Sq={sq} Sk={sk} H={h} "
                         f"Hkv={hkv} D={d} dtype={q.dtype}"))


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
