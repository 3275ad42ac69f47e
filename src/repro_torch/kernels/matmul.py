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
cores.  :func:`kernel_path` picks one of three paths by dtype alone:

* ``"wgmma"`` — f16/bf16, every shape: TMA loads into a ring of
  shared-memory stages, ``wgmma`` on two warpgroups, f32 accumulators.
  TMA reads rows whose byte length is a multiple of 16 from 16-byte
  aligned bases; an operand that is not so (K or N not a multiple of 8,
  or a base off 16 bytes) is first staged by :func:`stage`;
* ``"dmma"`` — f64, every shape: ``mma.sync`` on the FP64 tensor cores
  (IEEE f64 FMA) fed by a ``cp.async`` ring;
* ``"simt"`` — f32 (IEEE FMA, never TF32), every shape: the CUDA-core
  loop, 8 x 8 sums a thread fed by 128-bit shared-memory reads, A
  prefetched into registers and B through a ``cp.async`` ring (16-byte
  copies where K, N and the bases allow, else 4-byte ones: the wrapper
  picks the variant, :func:`simt_vec`, and counts it).

Each path has its own table of compiled block shapes; ``blocks=`` must
come from the table of the path the call takes.  The simt and dmma paths
read the stacked tiles in place (no transpose, reshape or pad copies:
ragged edges read as zeros), as does wgmma wherever TMA can.

The kernel or its plain version is chosen by the tensors' device:
CPU tensors take ``kernels.ref.batched_contract_ref``; CUDA tensors
launch the kernel or raise.  Nothing falls back.  The kernel has no
backward (neither has the reference's Pallas kernel): on the card a call
whose operands require grad, with grad mode on, raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.dtypes import TORCH_DTYPES, accumulator_dtype, canonical_dtype
from . import build
from .ref import ACTIVATIONS, batched_contract_ref

PATHS: Tuple[str, ...] = ("wgmma", "dmma", "simt")
PATH_CODES = {"simt": 0, "wgmma": 1, "dmma": 2}  # csrc/blasx_gemm.cu Path
# the blocks compiled into the library, by path: (block_m, block_n,
# block_k) -> stages of its shared-memory ring (the .cu's BLASX_*_BLOCKS
# lists).  wgmma 128 x 128 tiles take 3 stages (two blocks on an SM),
# 128 x 256 tiles 4 (one block).  simt (f32 only) rings B; its narrow
# tiles are for outputs 64 wide or less.
BLOCKS: Dict[str, Dict[Tuple[int, int, int], int]] = {
    "simt": {(128, 128, 16): 3, (64, 128, 16): 3, (128, 64, 16): 3,
             (64, 64, 16): 3},
    "wgmma": {(128, 128, 64): 3, (128, 256, 64): 4},
    "dmma": {(64, 64, 16): 3, (128, 64, 16): 3},
}
SMEM_PAD = 4          # elements of skew in the simt and dmma stages
SMEM_BUDGET = 232448  # bytes of shared memory one block may use (227 KB)
TMA_ROW = 8           # a 16-bit row TMA reads is a multiple of 8 elements

# the epilogue's activation codes (csrc/blasx_gemm.cu ``enum Act``)
ACTIVATION_CODES = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3,
                    "tanh": 4}

# the simt path's copy variants, by the floats one copy moves
SIMT_COPIES = {4: "16-byte", 1: "4-byte"}

def _path(itemsize: int) -> str:
    return {8: "dmma", 2: "wgmma"}.get(itemsize, "simt")


def kernel_path(dtype) -> str:
    """The path a product of ``dtype`` takes on the card: ``"dmma"`` for
    f64, ``"wgmma"`` for f16/bf16, ``"simt"`` for f32, whatever the
    shape (:func:`operand_staging` says which 16-bit operands are staged
    first); the kernel is told the path and only refuses operands the
    path cannot read."""
    return _path(canonical_dtype(dtype).itemsize)


def operand_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """:func:`kernel_path` of ``a (..., M, K) @ b (..., K, N)``."""
    return kernel_path(a.dtype)


def operand_staging(a: torch.Tensor, b: torch.Tensor) -> Tuple[bool, bool]:
    """Whether the wgmma path reads ``a (..., M, K)`` and ``b (..., K, N)``
    through a staged copy: a 16-bit operand whose row is not a multiple
    of 8 elements, or whose base is off 16 bytes, is one TMA cannot read
    in place.  Other dtypes are never staged."""
    if a.element_size() != 2:
        return (False, False)
    return tuple(x.shape[-1] % TMA_ROW != 0 or x.data_ptr() % 16 != 0
                 for x in (a, b))


def simt_vec(a: torch.Tensor, b: torch.Tensor) -> int:
    """The floats one copy of the f32 simt kernel moves for ``a (..., M,
    K)`` and ``b (..., K, N)``: 4 (16-byte A loads and B copies) where K
    and N are multiples of 4 and both bases 16-byte aligned, else 1
    (4-byte ones, which take every shape and offset)."""
    aligned = all(x.shape[-1] % 4 == 0 and x.data_ptr() % 16 == 0
                  for x in (a, b))
    return 4 if aligned else 1


def stage(x: torch.Tensor) -> torch.Tensor:
    """One zero-padded copy of ``x (..., R, C)`` into a fresh buffer
    ``(..., R, C8)``, C8 being C rounded up to a multiple of 8: rows TMA
    can read, from the allocator's (16-byte aligned) base.  Its first C
    columns are ``x``; the kernel never reads the others."""
    c = x.shape[-1]
    out = x.new_empty((*x.shape[:-1], -(-c // TMA_ROW) * TMA_ROW))
    out[..., :c] = x
    out[..., c:] = 0  # fewer than 8 columns a row: not a second full pass
    return out


def compiled_blocks(path: str) -> Tuple[Tuple[int, int, int], ...]:
    """Every ``(block_m, block_n, block_k)`` compiled for ``path``."""
    if path not in BLOCKS:
        raise ValueError(f"unknown path {path!r}; choose from {PATHS}")
    return tuple(BLOCKS[path])


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int,
               path: str = "simt") -> int:
    """Shared memory of one block of ``path``, ``itemsize`` being the
    bytes of one staged element: simt two k-major A slabs (skewed by
    ``SMEM_PAD``) and a ring of B slabs in f32; dmma a ring of padded
    f64 stages; wgmma a ring of 16-bit stages, a full and an empty
    barrier per stage, and 1 KB of slack to align the tiles for the
    128-byte swizzle.  The stages are the compiled table's."""
    if path not in BLOCKS:
        raise ValueError(f"unknown path {path!r}; choose from {PATHS}")
    stages = BLOCKS[path][(bm, bn, bk)]
    if path == "simt":
        return (2 * bk * (bm + SMEM_PAD) + stages * bk * bn) * itemsize
    if path == "dmma":
        return stages * (bm * (bk + SMEM_PAD) + bk * (bn + SMEM_PAD)) \
            * itemsize
    return stages * (bm * bk + bk * bn) * itemsize + 2 * stages * 8 + 1024


def default_blocks(m: int, n: int, k: int, itemsize: int,
                   path: Optional[str] = None) -> Tuple[int, int, int]:
    """Pick ``(block_m, block_n, block_k)`` from the compiled table of
    ``path`` (default: the path of ``itemsize``).  wgmma: 128 x 256
    tiles once N > 128, else 128 x 128.  dmma: 64 rows where M is
    narrow, else 128, by 64 columns.  simt: 128 x 128 x 16, 64 rows or
    columns where the output is that narrow."""
    path = path or _path(itemsize)
    if path == "wgmma":
        return (128, 256, 64) if n > 128 else (128, 128, 64)
    if path == "dmma":
        return (128 if m > 64 else 64, 64, 16)
    return (128 if m > 64 else 64, 128 if n > 64 else 64, 16)


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
    if a.dtype not in build._DTYPE_CODES:
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
    # path, dtype, out_acc, a, b, bias, act, c, G, S, M, K, N, lda, ldb,
    # bm, bn, bk, stages, vec, stream
    return build.bind("blasx_gemm", "blasx_batched_gemm",
                      [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                      + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 12
                      + [ctypes.c_void_p])


class Operands(NamedTuple):
    """What a launch reads: ``a (G, S, M, lda)`` and ``b (G, S, K, ldb)``
    holding the logical ``(..., M, K)`` and ``(..., K, N)`` operands in
    their first K and N columns (lda = K and ldb = N unless staged)."""

    a: torch.Tensor
    b: torch.Tensor
    k: int
    n: int
    staged: bool = False  # whether either is a stage() copy


def stage_operands(a: torch.Tensor, b: torch.Tensor) -> Operands:
    """The operands a launch reads: each 16-bit operand TMA cannot read
    in place (:func:`operand_staging`) as a :func:`stage` copy, the
    others as they are."""
    k, n = a.shape[-1], b.shape[-1]
    stage_a, stage_b = operand_staging(a, b)
    return Operands(stage(a) if stage_a else a, stage(b) if stage_b else b,
                    k, n, stage_a or stage_b)


def _no_grad_check(*xs: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in xs):
        raise RuntimeError(
            "blasx_batched_gemm has no backward (nor has the reference's "
            "Pallas kernel): call it on tensors that do not require grad, "
            "or under torch.no_grad()")


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
    ``ACTIVATIONS``) is taken for G = 1, S = 1 only.

    On the card a 16-bit operand TMA cannot read in place is staged
    first (:func:`stage_operands`): one extra read and write of it, and
    a transient copy of its size with rows rounded up to 8 elements,
    held until the launch is queued.  f32 and f64 are never copied."""
    _check(a, b)
    g, s, m, k = a.shape
    n = b.shape[3]
    path = operand_path(a, b)
    if blocks is not None:
        check_blocks(*blocks, path=path)
    check_epilogue(bias, activation, n)
    if (bias is not None or ACTIVATION_CODES[activation] != 0) and \
            (g != 1 or s != 1):
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
    return _launch(stage_operands(a, b), out_dtype, blocks=blocks,
                   bias=bias, activation=activation)


def _launch(ops: Operands, out_dtype: Optional[torch.dtype] = None, *,
            blocks: Optional[Tuple[int, int, int]] = None,
            bias: Optional[torch.Tensor] = None,
            activation: Optional[str] = None) -> torch.Tensor:
    """The kernel's launch on CUDA operands as :func:`batched_contract`
    has checked and staged them (``bias`` contiguous in the accumulator
    type), counted in the ledger with its tags: ``"epilogue"``,
    ``"staged"`` and simt's copy variant (``SIMT_COPIES``)."""
    a, b = ops.a, ops.b
    g, s, m, _ = a.shape
    k, n = ops.k, ops.n
    path = operand_path(a, b)
    vec = simt_vec(a, b) if path == "simt" else 0
    _no_grad_check(a, b, bias)
    bm, bn, bk = blocks or default_blocks(m, n, k, a.element_size(), path)
    # the kernel writes the storage type or the accumulator type; any
    # other requested type is one cast of the result
    out_dtype = out_dtype or a.dtype
    acc = accumulator_dtype(a.dtype)
    out_acc = out_dtype == acc and acc != a.dtype
    c = torch.empty((g, m, n), device=a.device,
                    dtype=out_dtype if out_acc else a.dtype)
    if c.numel() == 0:
        return c.to(out_dtype)
    epilogue = bias is not None or ACTIVATION_CODES[activation] != 0
    tags = (("epilogue",) * epilogue + ("staged",) * ops.staged
            + ((SIMT_COPIES[vec],) if vec else ()))
    build.launch(
        _entry(), a.device, PATH_CODES[path], build._DTYPE_CODES[a.dtype],
        int(out_acc), a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(),
        ACTIVATION_CODES[activation], c.data_ptr(), g, s, m, k, n,
        a.shape[3], b.shape[3], bm, bn, bk, BLOCKS[path][(bm, bn, bk)], vec,
        key=("gemm", path, a.dtype, tags),
        details=lambda: (f"G={g} S={s} M={m} K={k} N={n} lda={a.shape[3]} "
                         f"ldb={b.shape[3]} blocks={bm}x{bn}x{bk} "
                         f"path={path} vec={vec} dtype={a.dtype} "
                         f"activation={activation}"))
    return c if c.dtype == out_dtype else c.to(out_dtype)
