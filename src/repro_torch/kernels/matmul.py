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
compute-bound.  The kernel answers with register blocking (each of 256
threads keeps an 8 x 8 accumulator at 128 x 128 blocks), reads the
stacked tiles in place (no transpose, reshape or pad copies: ragged
edges are masked loads), and accumulates on the CUDA cores in f64 for
f64 and in f32 for everything else — f32 never takes TF32.  It does
not use the tensor cores yet, so bf16/f16 run far below their bound.

The kernel or its plain version is chosen by the tensors' device:
CPU tensors take ``kernels.ref.batched_contract_ref``; CUDA tensors
launch the kernel or raise.  Nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.dtypes import TORCH_DTYPES, accumulator_dtype, dtype_name
from . import build
from .ref import ACTIVATIONS, batched_contract_ref

# block shapes compiled into the library (csrc/blasx_gemm.cu dispatch)
BLOCK_MN: Tuple[int, ...] = (64, 128)
BLOCK_K: Tuple[int, ...] = (8, 16, 32)
SMEM_PAD = 4          # elements of skew in the transposed A sub-tile
SMEM_BUDGET = 232448  # bytes of shared memory one block may use (227 KB)

_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.float16: 2,
                torch.bfloat16: 3}

# the epilogue's activation codes (csrc/blasx_gemm.cu ``enum Act``)
ACTIVATION_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3,
                    "tanh": 4}

# launches of the kernel in this process, in all and by storage dtype,
# and those of them with an epilogue (plain-version calls never count)
LAUNCHES = 0
LAUNCHES_BY_DTYPE: Dict[str, int] = {}
LAUNCHES_EPILOGUE = 0
_count_lock = threading.Lock()


def smem_bytes(bm: int, bn: int, bk: int, acc_itemsize: int) -> int:
    """Shared memory of one block: the transposed A sub-tile (skewed
    by ``SMEM_PAD``) plus the B sub-tile, in the accumulator type."""
    return bk * (bm + SMEM_PAD + bn) * acc_itemsize


def default_blocks(m: int, n: int, k: int, itemsize: int
                   ) -> Tuple[int, int, int]:
    """Pick ``(block_m, block_n, block_k)`` from the compiled table:
    128-wide tiles unless the output is narrow, BK = 16, shrunk until
    the block fits the shared-memory budget."""
    acc = 8 if itemsize == 8 else 4
    bm = 128 if m > 64 else 64
    bn = 128 if n > 64 else 64
    bk = 16 if k > 8 else 8
    while smem_bytes(bm, bn, bk, acc) > SMEM_BUDGET and bk > BLOCK_K[0]:
        bk //= 2
    return bm, bn, bk


def check_blocks(bm: int, bn: int, bk: int) -> None:
    if bm not in BLOCK_MN or bn not in BLOCK_MN or bk not in BLOCK_K:
        raise ValueError(
            f"blocks ({bm}, {bn}, {bk}) outside the compiled table: "
            f"block_m/block_n in {BLOCK_MN}, block_k in {BLOCK_K}")


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


def _entry():
    fn = build.load("blasx_gemm").blasx_batched_gemm
    # dtype, out_acc, a, b, bias, act, c, G, S, M, K, N, bm, bn, bk, stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def batched_contract(a: torch.Tensor, b: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None, *,
                     blocks: Optional[Tuple[int, int, int]] = None,
                     bias: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None) -> torch.Tensor:
    """``c[g] = act(sum_s a[g, s] @ b[g, s] + bias)`` -> ``(G, M, N)`` in
    ``out_dtype`` (default: the operands' dtype).  ``blocks`` overrides
    the ``(block_m, block_n, block_k)`` choice of :func:`default_blocks`.
    The epilogue (``bias`` of N values, ``activation`` from
    ``ACTIVATIONS``) is taken for G = 1, S = 1 only."""
    global LAUNCHES, LAUNCHES_EPILOGUE
    _check(a, b)
    if blocks is not None:
        check_blocks(*blocks)
    g, s, m, k = a.shape
    n = b.shape[3]
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
    bm, bn, bk = blocks or default_blocks(m, n, k, a.element_size())
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
        rc = _entry()(_DTYPE_CODES[a.dtype], int(out_acc), a.data_ptr(),
                      b.data_ptr(), None if bias is None else bias.data_ptr(),
                      ACTIVATION_CODES[activation], c.data_ptr(), g, s, m, k,
                      n, bm, bn, bk, stream)
    if rc != 0:
        raise RuntimeError(f"blasx_batched_gemm launch failed: error {rc} "
                           f"(G={g} S={s} M={m} K={k} N={n} "
                           f"blocks={bm}x{bn}x{bk} dtype={a.dtype} "
                           f"activation={activation})")
    with _count_lock:
        LAUNCHES += 1
        LAUNCHES_EPILOGUE += int(epilogue)
        name = dtype_name(a.dtype)
        LAUNCHES_BY_DTYPE[name] = LAUNCHES_BY_DTYPE.get(name, 0) + 1
    return c if c.dtype == out_dtype else c.to(out_dtype)
