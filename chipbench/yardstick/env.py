"""The run's environment: cache directories, the card, the import check."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

# top-level module names no process of a run may hold once its window
# has closed: JAX, its companions, and the JAX package this port mirrors
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs(repo: Path) -> dict:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds.  The port's own GEMM
    library goes to ``build/repro_torch/`` by itself."""
    base = repo / "build" / "chipbench"
    return {
        "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
        "TRITON_CACHE_DIR": str(base / "triton"),
        "CUDA_CACHE_PATH": str(base / "cuda_cache"),
    }


def prepare(repo: Path) -> None:
    """Point the caches into the checkout and put the port on the path;
    raise if the checkout holds no port."""
    for key, value in cache_dirs(repo).items():
        os.environ[key] = value
        Path(value).mkdir(parents=True, exist_ok=True)
    src = repo / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise RuntimeError(f"no port to measure: {src / 'repro_torch'} "
                           "is missing")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def forbidden_modules() -> List[str]:
    """Modules of this process whose top-level name, compared whole, is
    forbidden."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """``name, power.limit`` of every card, as ``nvidia-smi`` reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    if proc.returncode != 0:
        return f"nvidia-smi failed: {proc.stderr.strip()[:200]}"
    return " | ".join(line.strip() for line in proc.stdout.splitlines()
                      if line.strip())


def say(*parts) -> None:
    print("[chipbench]", *parts, file=sys.stderr, flush=True)
