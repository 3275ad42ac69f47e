"""Roofline terms of a dry-run step, with the H100's figures.

The counterpart of the reference's ``launch/roofline.py``:

    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = bytes accessed   / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)

The reference takes its FLOPs and bytes from XLA's cost analysis of the
compiled HLO and parses its collective bytes out of the HLO text; the
port's dry-run (``launch/dryrun.py``) counts them while it traces the
step on fake tensors, and the HLO parser here is kept for the same
text format.  The string parsing and the arithmetic are copies of the
reference's; only the constants are the card's.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit).  None of the
reference's TPU constants carries over.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

# dense BF16 (and FP16) tensor-core rate, FLOP/s: the scalar peak of the
# compute term, as the reference's is its chip's bf16 rate
PEAK_FLOPS = 989e12
# the peak a dtype's arithmetic runs at: FP64 on the tensor cores, FP32
# outside them (TF32 is other arithmetic), BF16/FP16 on the tensor cores
PEAK_FLOPS_BY_DTYPE = {"float64": 67e12, "float32": 67e12,
                       "bfloat16": 989e12, "float16": 989e12}
PEAK_NAME = {"float64": "FP64 tensor 67 TFLOP/s",
             "float32": "FP32 non-tensor 67 TFLOP/s",
             "bfloat16": "BF16 dense tensor 989 TFLOP/s",
             "float16": "FP16 dense tensor 989 TFLOP/s"}
# HBM3, bytes/s
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s a GPU to the other cards of the host, 450 GB/s
# each way (the data sheet; the Hopper architecture white paper)
LINK_BW = 4.5e11

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# wire-byte weights: ring all-reduce moves 2(n-1)/n of the payload per
# participant; gather/scatter/a2a move (n-1)/n; a permute moves exactly
# its operand.  With n=256 the factors round to 2/1/1/1/1.
WIRE_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def least_time(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by) of one call: the larger of its operations
    over ``dtype``'s peak and its bytes (inputs read once, outputs
    written once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS_BY_DTYPE[dtype], nbytes / HBM_BW
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def wire_bytes(breakdown: Dict[str, int]) -> float:
    """Per-kind operand bytes -> modeled wire bytes."""
    return float(sum(WIRE_WEIGHT.get(k, 1.0) * v
                     for k, v in breakdown.items()))


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2,
    "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)\s*=\s*(.+?)\s+"
                       r"([\w\-]+)\((.*)\)")


def shape_bytes(type_str: str) -> int:
    """Bytes of one HLO type string, incl. tuple types."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum operand sizes per collective kind across an HLO module."""
    # symbol table: %name -> result type string
    symtab: Dict[str, str] = {}
    pending: List[tuple] = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, rtype, op, args = m.groups()
        symtab[name.lstrip("%")] = rtype
        base = op.rstrip(".0123456789")
        for kind in COLLECTIVE_OPS:
            if base == kind or base.startswith(kind + "-"):
                pending.append((kind, rtype, args))
                break

    out = {k: 0 for k in COLLECTIVE_OPS}
    for kind, rtype, args in pending:
        nbytes = 0
        # operands may carry inline types, else resolve via symtab
        for arg in _split_args(args):
            arg = arg.strip()
            if not arg:
                continue
            inline = _SHAPE_RE.search(arg.split("%")[0])
            if inline:
                nbytes += shape_bytes(arg.split("%")[0])
                continue
            ref = arg.lstrip("%").split(" ")[0].split(")")[0]
            t = symtab.get(ref)
            if t:
                nbytes += shape_bytes(t)
        if nbytes == 0:   # fallback: use the result type
            nbytes = shape_bytes(rtype)
        out[kind] += nbytes
    return out


def _split_args(args: str) -> List[str]:
    """Split an HLO operand list at top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in args:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    model_flops: float
    bytes_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        # coll_bytes carries operand bytes x chips; weight to wire
        return (wire_bytes(self.coll_breakdown)
                / sum(self.coll_breakdown.values())
                * self.coll_bytes if sum(self.coll_breakdown.values())
                else self.coll_bytes) / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the traced compute
        is useful (catches remat recompute and dispatch waste)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_frac(self) -> float:
        """Fraction of the step spent at the roofline if the dominant
        term were perfectly attained by useful model FLOPs."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s if self.bound_s else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
            "bytes_per_device": self.bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense train) / 6*N_active*D (MoE), with the
    2*N*D forward-only variant for serving shapes."""
    n_params = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params * tokens
    # decode: one token per sequence
    return 2.0 * n_params * shape.global_batch
