"""Wrapper of the held experts' grouped kernels (``csrc/moe_experts.cu``).

``moe_experts(x, experts, weights, w_gate, w_up, w_down, first,
n_experts)`` computes one card's part of a dropless MoE layer of SwiGLU
experts: for each (token t, slot k) routed to a held expert
e = experts[t, k] - first (0 <= e < held),

    h = silu(x[t] W_gate[e]) * (x[t] W_up[e])   in f32, rounded once to
                                                 x's dtype
    y[t] += weights[t, k] * (h W_down[e])        in f32

x ``(N, d)``; ``experts`` ``(N, K)`` int64 and ``weights`` ``(N, K)``
from the router over ``n_experts``; the held experts' weights
``(held, d, ff)``, ``(held, d, ff)`` and ``(held, ff, d)`` in x's dtype.
Returns y ``(N, d)`` (f32; f64 in an f64 model) and ``offsets``
``(held + 1,)`` on x's device, an exclusive scan of the slots each held
expert got.  It replaces no TPU kernel: the reference's MoE is einsums
(``src/repro/models/moe.py``); ``kernels.ref.moe_experts_ref`` is the
port's plain version, the per-expert loop the layer ran before.

The plain version or the kernels are chosen by the tensors' device: CPU
tensors take :func:`~repro_torch.kernels.ref.moe_experts_ref`; CUDA
tensors launch the kernels (bf16 alone) or raise.  Nothing falls back.
A card call is three launches of the ledger, all on ``wgmma`` (path
``PATH``): ``moe_layout`` (the slots sorted by expert on the device,
their token rows gathered, y zeroed) and two of ``moe_experts``, tagged
``"gate_up"`` and ``"down"``.  Nothing here reads a count to the host:
the kernels read ``offsets`` on the device, and their grids are sized
from N, K, the held experts and the card's SMs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..core.dtypes import dtype_name
from . import build
from .ref import moe_experts_ref

# what the library compiles (csrc/moe_experts.cu's MOE_* defines): the
# weight columns and K of a tile, the token rows a tile can take, the
# most held experts a layer
BM, BK = 128, 64
TILE_SMALL, TILE_LARGE = 64, 128
MAX_HELD = 64
PATH = "wgmma"
# the one dtype the kernels compile: DeepSeek-V3's
DTYPES: Tuple[torch.dtype, ...] = (torch.bfloat16,)
# the down product's K is cut into runs of at least this many BK tiles,
# so that its tiles fill the card's SMs several times over (at ff 2048:
# 2 runs; each run's sum is added to y on its own)
SPLIT_TILES = 16


def token_tile(slots: int, n_experts: int) -> int:
    """The token rows of a tile for a call routing ``slots`` (token,
    slot)s over ``n_experts``: the small tile where an expert gets at
    most half of it on average (decode), else the large one (prefill),
    so that an expert's weights are streamed once a tile of its rows."""
    return TILE_SMALL if 2 * slots <= TILE_SMALL * n_experts else TILE_LARGE


def splits(k: int) -> int:
    """The runs the down product's K (ff) is cut into."""
    return max(1, -(-k // BK) // SPLIT_TILES)


def _check(x, experts, weights, w_gate, w_up, w_down) -> None:
    """Raise on anything the layer does not take, on every device, so a
    call that passes on the CPU passes the same checks on the card."""
    named = (("x", x), ("experts", experts), ("weights", weights),
             ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"moe_experts takes torch tensors ({name})")
        if t.device != x.device:
            raise ValueError(f"operands on different devices: {x.device} "
                             f"and {t.device} ({name})")
    if x.ndim != 2 or experts.ndim != 2:
        raise ValueError(f"x and experts must be 2-D, got {tuple(x.shape)} "
                         f"and {tuple(experts.shape)}")
    n, d = x.shape
    if experts.shape[0] != n or weights.shape != experts.shape:
        raise ValueError(f"routes must be ({n}, K): experts "
                         f"{tuple(experts.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if experts.dtype != torch.int64 or not weights.is_floating_point():
        raise ValueError(f"experts must be int64 and weights floating "
                         f"point, got {experts.dtype} and {weights.dtype}")
    if w_gate.ndim != 3 or w_gate.shape[1] != d:
        raise ValueError(f"w_gate must be (held, {d}, ff), got "
                         f"{tuple(w_gate.shape)}")
    held, _, ff = w_gate.shape
    if w_up.shape != w_gate.shape or w_down.shape != (held, ff, d):
        raise ValueError(f"shape mismatch: w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    for name, t in named[3:]:
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x {x.dtype}")


def _card_check(x, w_gate, w_up, w_down) -> None:
    """What the kernels take beyond :func:`_check`."""
    if x.dtype not in DTYPES:
        raise ValueError(f"no kernel for {x.dtype}; it takes "
                         f"{sorted(dtype_name(t) for t in DTYPES)}")
    held, d, ff = w_gate.shape
    if not 0 < held <= MAX_HELD:
        raise ValueError(f"the kernels take 1 to {MAX_HELD} held experts, "
                         f"got {held}")
    if d % 8 or ff % 8:
        raise ValueError(f"d and ff must be multiples of 8 (whole 16-byte "
                         f"rows for TMA), got {d} and {ff}")
    if w_up.stride() != w_gate.stride():
        raise ValueError("w_gate and w_up must share their strides")
    # TMA reads the weights in place: 16-byte aligned bases and strides
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if (w.stride(2) != 1 or w.stride(0) % 8 or w.stride(1) % 8
                or w.data_ptr() % 16):
            raise ValueError(f"{name} must have its last axis contiguous, a "
                             f"16-byte aligned base and strides of whole "
                             f"16-byte chunks, got strides {w.stride()}")


@functools.lru_cache(maxsize=None)
def _layout_entry():
    # dtype, experts, weights, x, N, K, d, lo, held, offsets, stok, sw,
    # xs, y, grid, stream
    return build.bind("moe_experts", "moe_layout",
                      [ctypes.c_int] + [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5
                      + [ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _grouped_entry():
    # dtype, gated, wn, w0, w1, ws_k, ws_e, xs, rows_max, offsets, held,
    # M, K, splits, out, ld_out, stok, sw, grid, stream
    return build.bind("moe_experts", "moe_grouped",
                      [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                      + [ctypes.c_longlong] * 2
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                      + [ctypes.c_int] * 4
                      + [ctypes.c_void_p, ctypes.c_longlong]
                      + [ctypes.c_void_p] * 2
                      + [ctypes.c_int, ctypes.c_void_p])


def _launch(x, experts, weights, w_gate, w_up, w_down, first: int,
            n_experts: int):
    """The three launches of a card call (module docstring)."""
    n, d = x.shape
    k = experts.shape[1]
    held, _, ff = w_gate.shape
    dev = x.device
    # every sorted slot has a row: a token's held slots are at most
    # min(K, held), and how many there are is known on the device alone
    rows = n * min(k, held)
    meta = torch.empty(held + 1 + 2 * rows, dtype=torch.int32, device=dev)
    offsets = meta[:held + 1]
    stok = meta[held + 1:held + 1 + rows]
    sw = meta[held + 1 + rows:].view(torch.float32)
    xs = torch.empty((rows, d), dtype=x.dtype, device=dev)
    h = torch.empty((rows, ff), dtype=x.dtype, device=dev)
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    sms = build._sm_count(dev.index)
    code = build._DTYPE_CODES[x.dtype]
    wn = token_tile(n * k, n_experts)
    ks = splits(ff)

    def details(what):
        return lambda: (f"{what} N={n} K={k} d={d} ff={ff} held={held} "
                        f"tile={wn} dtype={x.dtype}")

    build.launch(
        _layout_entry(), dev, code, experts.data_ptr(), weights.data_ptr(),
        x.data_ptr(), n, k, d, first, held, offsets.data_ptr(),
        stok.data_ptr(), sw.data_ptr(), xs.data_ptr(), y.data_ptr(), 2 * sms,
        key=("moe_layout", PATH, x.dtype, ()), details=details("layout"))
    build.launch(
        _grouped_entry(), dev, code, 1, wn, w_gate.data_ptr(),
        w_up.data_ptr(), w_gate.stride(1), w_gate.stride(0), xs.data_ptr(),
        rows, offsets.data_ptr(), held, ff, d, 1, h.data_ptr(), ff, None,
        None, sms, key=("moe_experts", PATH, x.dtype, ("gate_up",)),
        details=details("gate_up"))
    build.launch(
        _grouped_entry(), dev, code, 0, wn, w_down.data_ptr(), None,
        w_down.stride(1), w_down.stride(0), h.data_ptr(), rows,
        offsets.data_ptr(), held, d, ff, ks, y.data_ptr(), d,
        stok.data_ptr(), sw.data_ptr(), sms,
        key=("moe_experts", PATH, x.dtype, ("down",)),
        details=details("down"))
    return y, offsets


def moe_experts(x: torch.Tensor, experts: torch.Tensor,
                weights: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor, first: int,
                n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, offsets) of the held experts ``first .. first + held - 1``
    (module docstring)."""
    _check(x, experts, weights, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return moe_experts_ref(x, experts, weights, w_gate, w_up, w_down,
                               first)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    _card_check(x, w_gate, w_up, w_down)
    return _launch(x.contiguous(), experts.contiguous(),
                   weights.to(torch.float32).contiguous(), w_gate, w_up,
                   w_down, first, n_experts)
