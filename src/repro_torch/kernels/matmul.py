"""Wrapper of the hand-written batched long-K GEMM (``csrc/blasx_gemm.cu``).

``batched_contract(a, b)`` computes ``c[g] = sum_s a[g, s] @ b[g, s]``
for stacked tiles a ``(G, S, M, K)`` and b ``(G, S, K, N)``: G
independent long-K chains in one launch, the unit the CUDA backend
hands it per step group.

It replaces three pieces of the reference's TPU path:

* ``kernels/matmul.py::_matmul_kernel`` — the Pallas tile matmul with
  its f32 VMEM accumulator;
* ``kernels/ops.py::matmul`` — the wrapper that zero-pads operands to
  block multiples and slices the result back;
* ``backends/pallas_backend.py::_batched_pallas_contract`` — the
  transpose/reshape of each item's k-chain into one
  ``(m, s*k) @ (s*k, n)`` matmul, vmapped over the group;
* ``kernels/matmul.py::_matmul_bias_kernel`` and the ``ACTIVATIONS``
  epilogue of both matmul bodies — an optional bias row and an
  activation applied to the sums before the cast, for a plain matmul
  (G = 1, S = 1) only.

What bounds it on the card: at the runtime's shapes (G=4, S=16, 1024^3
tiles) the work is hundreds of flops per byte moved, so it is
compute-bound, and for f16/bf16/f64 the card's compute is in its tensor
cores.  :func:`kernel_path` picks one of three paths by dtype and
alignment alone:

* ``"wgmma"`` — f16/bf16 with K and N multiples of 8 and 16-byte aligned
  operands (what TMA takes): TMA loads into a ring of shared-memory
  stages, ``wgmma`` on two warpgroups, f32 accumulators;
* ``"dmma"`` — f64, every shape: ``mma.sync`` on the FP64 tensor cores
  (IEEE f64 FMA) fed by a ``cp.async`` ring;
* ``"simt"`` — f32 (never TF32) and the 16-bit shapes TMA cannot read:
  the CUDA-core register-blocked loop.

Each path has its own table of compiled block shapes; ``blocks=`` must
come from the table of the path the call takes.  Every path reads the
stacked tiles in place (no transpose, reshape or pad copies: ragged
edges read as zeros).

The kernel or its plain version is chosen by the tensors' device:
CPU tensors take ``kernels.ref.batched_contract_ref``; CUDA tensors
launch the kernel or raise.  Nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.dtypes import (TORCH_DTYPES, accumulator_dtype, canonical_dtype,
                           dtype_name)
from . import build
from .ref import ACTIVATIONS, batched_contract_ref

PATHS: Tuple[str, ...] = ("wgmma", "dmma", "simt")
PATH_CODES = {"simt": 0, "wgmma": 1, "dmma": 2}  # csrc/blasx_gemm.cu Path
# the blocks compiled into the library, by path: (block_m, block_n,
# block_k) -> stages of its shared-memory ring (the .cu's BLASX_*_BLOCKS
# lists; simt has no ring).  wgmma 128 x 128 tiles take 3 stages (two
# blocks on an SM), 128 x 256 tiles 4 (one block).
BLOCKS: Dict[str, Dict[Tuple[int, int, int], int]] = {
    "simt": {(bm, bn, bk): 1 for bm in (64, 128) for bn in (64, 128)
             for bk in (8, 16, 32)},
    "wgmma": {(128, 128, 64): 3, (128, 256, 64): 4},
    "dmma": {(64, 64, 16): 3, (128, 64, 16): 3},
}
SMEM_PAD = 4          # elements of skew in the simt and dmma stages
SMEM_BUDGET = 232448  # bytes of shared memory one block may use (227 KB)

_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.float16: 2,
                torch.bfloat16: 3}

# the epilogue's activation codes (csrc/blasx_gemm.cu ``enum Act``)
ACTIVATION_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3,
                    "tanh": 4}

# launches of the kernel in this process, in all, by storage dtype, by
# path and dtype ({"wgmma": {"bfloat16": n}, ...}), and those with an
# epilogue (plain-version calls never count)
LAUNCHES = 0
LAUNCHES_BY_DTYPE: Dict[str, int] = {}
LAUNCHES_BY_PATH: Dict[str, Dict[str, int]] = {}
LAUNCHES_EPILOGUE = 0
_count_lock = threading.Lock()


def _path(itemsize: int, k: int, n: int, aligned: bool = True) -> str:
    if itemsize == 8:
        return "dmma"
    if itemsize == 2 and k % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    return "simt"


def kernel_path(dtype, m: int, k: int, n: int, *,
                aligned: bool = True) -> str:
    """The path a ``(M, K) x (K, N)`` product of ``dtype`` takes on the
    card: ``"dmma"`` for f64, ``"wgmma"`` for f16/bf16 whose row strides
    TMA can read (K and N multiples of 8) from 16-byte aligned bases
    (``aligned``), else ``"simt"`` (f32 and the other 16-bit shapes).
    M never matters.  The kernel is told the path; it only refuses
    operands the path cannot read."""
    return _path(canonical_dtype(dtype).itemsize, k, n, aligned)


def operand_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """:func:`kernel_path` of ``a (..., M, K) @ b (..., K, N)``, alignment
    read from the tensors' addresses (a view at another storage offset
    may take another path)."""
    return kernel_path(a.dtype, a.shape[-2], a.shape[-1], b.shape[-1],
                       aligned=a.data_ptr() % 16 == 0
                       and b.data_ptr() % 16 == 0)


def compiled_blocks(path: str) -> Tuple[Tuple[int, int, int], ...]:
    """Every ``(block_m, block_n, block_k)`` compiled for ``path``."""
    if path not in BLOCKS:
        raise ValueError(f"unknown path {path!r}; choose from {PATHS}")
    return tuple(BLOCKS[path])


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int,
               path: str = "simt") -> int:
    """Shared memory of one block of ``path``, ``itemsize`` being the
    bytes of one staged element: simt stages the transposed A sub-tile
    (skewed by ``SMEM_PAD``) and the B sub-tile in f32; dmma a ring of
    padded f64 stages; wgmma a ring of 16-bit stages, a full and an
    empty barrier per stage, and 1 KB of slack to align the tiles for
    the 128-byte swizzle.  The stages are the compiled table's."""
    if path == "simt":
        return bk * (bm + SMEM_PAD + bn) * itemsize
    stages = BLOCKS[path][(bm, bn, bk)] if path in BLOCKS else 0
    if path == "dmma":
        return stages * (bm * (bk + SMEM_PAD) + bk * (bn + SMEM_PAD)) \
            * itemsize
    if path == "wgmma":
        return stages * (bm * bk + bk * bn) * itemsize + 2 * stages * 8 + 1024
    raise ValueError(f"unknown path {path!r}; choose from {PATHS}")


def default_blocks(m: int, n: int, k: int, itemsize: int,
                   path: Optional[str] = None) -> Tuple[int, int, int]:
    """Pick ``(block_m, block_n, block_k)`` from the compiled table of
    ``path`` (default: the path the shape takes from aligned operands).
    wgmma: 128 x 256 tiles once N > 128, else 128 x 128.  dmma: 64 rows
    where M is narrow, else 128, by 64 columns.  simt: 128-wide tiles
    unless the output is narrow, BK = 16 (8 for K <= 8); every simt
    block stages f32 and fits the budget many times over."""
    path = path or _path(itemsize, k, n)
    if path == "wgmma":
        return (128, 256, 64) if n > 128 else (128, 128, 64)
    if path == "dmma":
        return (128 if m > 64 else 64, 64, 16)
    return (128 if m > 64 else 64, 128 if n > 64 else 64,
            16 if k > 8 else 8)


def check_blocks(bm: int, bn: int, bk: int, path: str = "simt") -> None:
    if (bm, bn, bk) not in compiled_blocks(path):
        raise ValueError(
            f"blocks ({bm}, {bn}, {bk}) outside the compiled table of the "
            f"{path} path: {list(compiled_blocks(path))}")


def check_epilogue(bias: Optional[torch.Tensor], activation: Optional[str],
                   n: int) -> None:
    """The reference's errors: a bias of another length than N, an
    activation outside the table."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}; choose from "
                         f"{sorted(k for k in ACTIVATION_CODES if k)}")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"bias length {bias.numel()} != N {n}")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on anything the kernel does not take — on every device, so
    a call that passes on the CPU passes on the card too."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        raise TypeError("batched_contract takes torch tensors")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} "
                         f"and {b.device}")
    if a.dtype != b.dtype:
        raise ValueError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {a.dtype}; the kernel takes "
                         f"{sorted(TORCH_DTYPES)}")
    if a.ndim != 4 or b.ndim != 4:
        raise ValueError(f"expected a (G,S,M,K) and b (G,S,K,N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[:2] != b.shape[:2] or a.shape[3] != b.shape[2]:
        raise ValueError(f"shape mismatch: a {tuple(a.shape)} vs "
                         f"b {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if a.shape[0] > 65535:
        raise ValueError(f"G={a.shape[0]} exceeds the grid's z limit 65535")
    if max(a.shape) >= 2 ** 31 or max(b.shape) >= 2 ** 31:
        raise ValueError("dimensions must fit in 32-bit ints")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("blasx_gemm").blasx_batched_gemm
    # path, dtype, out_acc, a, b, bias, act, c, G, S, M, K, N, bm, bn, bk,
    # stages, stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_contract(a: torch.Tensor, b: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None, *,
                     blocks: Optional[Tuple[int, int, int]] = None,
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None) -> torch.Tensor:
    """``c[g] = act(sum_s a[g, s] @ b[g, s] + bias)`` -> ``(G, M, N)`` in
    ``out_dtype`` (default: the operands' dtype).  ``blocks`` overrides
    the ``(block_m, block_n, block_k)`` choice of :func:`default_blocks`
    and must come from the compiled table of the call's
    :func:`kernel_path`.
    The epilogue (``bias`` of N values, ``activation`` from
    ``ACTIVATIONS``) is taken for G = 1, S = 1 only."""
    global LAUNCHES, LAUNCHES_EPILOGUE
    _check(a, b)
    g, s, m, k = a.shape
    n = b.shape[3]
    path = operand_path(a, b)
    if blocks is not None:
        check_blocks(*blocks, path=path)
    check_epilogue(bias, activation, n)
    epilogue = bias is not None or ACTIVATION_CODES[activation] != 0
    if epilogue and (g != 1 or s != 1):
        raise ValueError(f"the epilogue is for a plain matmul (G = S = 1), "
                         f"got G={g} S={s}")
    if bias is not None:
        if bias.device != a.device:
            raise ValueError(f"bias on {bias.device}, operands on "
                             f"{a.device}")
        # the reference adds bias.astype(f32): the kernel reads the
        # accumulator type
        bias = bias.reshape(-1).to(accumulator_dtype(a.dtype)).contiguous()
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return batched_contract_ref(a, b, out_dtype, bias, activation)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {a.device}")
    bm, bn, bk = blocks or default_blocks(m, n, k, a.element_size(), path)
    # the kernel writes the storage type or the accumulator type; any
    # other requested type is one cast of the result
    acc = accumulator_dtype(a.dtype)
    out_acc = out_dtype == acc and acc != a.dtype
    c = torch.empty((g, m, n), device=a.device,
                    dtype=out_dtype if out_acc else a.dtype)
    if c.numel() == 0:
        return c.to(out_dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _entry()(PATH_CODES[path], _DTYPE_CODES[a.dtype], int(out_acc),
                      a.data_ptr(), b.data_ptr(),
                      None if bias is None else bias.data_ptr(),
                      ACTIVATION_CODES[activation], c.data_ptr(), g, s, m, k,
                      n, bm, bn, bk, BLOCKS[path][(bm, bn, bk)], stream)
    if rc != 0:
        raise RuntimeError(f"blasx_batched_gemm launch failed: error {rc} "
                           f"(G={g} S={s} M={m} K={k} N={n} "
                           f"blocks={bm}x{bn}x{bk} path={path} "
                           f"dtype={a.dtype} "
                           f"activation={activation})")
    with _count_lock:
        LAUNCHES += 1
        LAUNCHES_EPILOGUE += int(epilogue)
        name = dtype_name(a.dtype)
        LAUNCHES_BY_DTYPE[name] = LAUNCHES_BY_DTYPE.get(name, 0) + 1
        by_dtype = LAUNCHES_BY_PATH.setdefault(path, {})
        by_dtype[name] = by_dtype.get(name, 0) + 1
    return c if c.dtype == out_dtype else c.to(out_dtype)
