"""Build, bind, launch and count the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into
a shared library with a plain C interface, which is loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds, not the
minutes of ``torch.utils.cpp_extension``.  The library lands in
``build/repro_torch/`` at the root of the checkout (git-ignored), named
by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  The libraries link only the CUDA
runtime: ``cuTensorMapEncodeTiled`` (TMA descriptors), which lives in
libcuda, is looked up at run time through ``cudaGetDriverEntryPoint``,
so there is no ``-lcuda`` flag.

Every wrapper launches through :func:`launch`, which calls a bound entry
point (:func:`bind`) on the current stream, raises on a nonzero return
code and records the launch in one ledger (``LAUNCHES``), read with
:func:`snapshot` and :func:`launches` and cleared with :func:`reset`.

Nothing here runs at import time: the tests import every module on
hosts with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.dtypes import dtype_name

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

# the ``dtype`` argument of every entry point under csrc/
_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.float16: 2,
                torch.bfloat16: 3}


class Launch(NamedTuple):
    """A key of the launch ledger: the kernel (``"gemm"``, ``"flash"``,
    ``"mla_decode"``, ``"moe_layout"``, ``"moe_experts"``), its path, the
    name of its dtype and its tags (``"epilogue"``, ``"staged"``, a simt
    copy variant such as ``"16-byte"``, a flash shape key such as
    ``"d80,causal"``, the MoE product ``"gate_up"`` or ``"down"``)."""

    kernel: str
    path: str
    dtype: str
    tags: Tuple[str, ...] = ()


# launches of the hand kernels in this process, by (kernel, path, torch
# dtype, tags); plain-version calls never count.  Bumped from every
# thread that launches (one worker per pooled context in a BlasxServer),
# so each bump is one locked update
LAUNCHES: Dict[tuple, int] = {}
_count_lock = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` goes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns its path.  The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept beside the library."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def bind(library: str, symbol: str, argtypes: Sequence) -> Callable:
    """The entry point ``symbol`` of the library built from
    ``csrc/<library>.cu``, taking ``argtypes`` and returning an int
    (0, or the code of what it refused)."""
    fn = getattr(load(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(entry: Callable, device: torch.device, *args,
           key: Tuple[str, str, torch.dtype, Tuple[str, ...]],
           details: Callable[[], str]) -> None:
    """``entry(*args, stream)`` on ``device``'s current stream.  A
    nonzero return raises ``RuntimeError`` naming the entry and
    ``details()``; a launch that returned 0 adds one to ``key``,
    (kernel, path, dtype, tags), in the ledger."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: error {rc} "
                           f"({details()})")
    with _count_lock:
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def reset() -> None:
    """Clear the ledger, every kernel at once."""
    with _count_lock:
        LAUNCHES.clear()


def snapshot() -> Dict[Launch, int]:
    """A copy of the ledger, keyed by :class:`Launch`."""
    with _count_lock:
        counts = list(LAUNCHES.items())
    return {Launch(kernel, path, dtype_name(dtype), tags): n
            for (kernel, path, dtype, tags), n in counts}


def launches(kernel: str, path: Optional[str] = None,
             dtype: Optional[str] = None, tag: Optional[str] = None) -> int:
    """The launches of ``kernel`` on ``path``, in the dtype named
    ``dtype`` and carrying ``tag``, each where given."""
    return sum(n for k, n in snapshot().items() if k.kernel == kernel
               and path in (None, k.path) and dtype in (None, k.dtype)
               and (tag is None or tag in k.tags))
