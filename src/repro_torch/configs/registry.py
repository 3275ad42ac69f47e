"""Architecture registry: ``--arch <id>`` -> ModelConfig (the port's
copy: it loads ``repro_torch.configs.<arch>``)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig

ARCH_IDS: List[str] = [
    "internvl2_26b",
    "olmo_1b",
    "phi3_medium_14b",
    "qwen3_0_6b",
    "glm4_9b",
    "deepseek_v3_671b",
    "olmoe_1b_7b",
    "seamless_m4t_medium",
    "zamba2_2_7b",
    "mamba2_780m",
    "blasx_gemm",          # the paper's own workload (tiled GEMM engine)
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS if a != "blasx_gemm"}
