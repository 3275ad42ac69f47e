from .base import SHAPES, ModelConfig, ShapeConfig, cell_supported
from .registry import ARCH_IDS, all_configs, get_config

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "cell_supported",
           "ARCH_IDS", "get_config", "all_configs"]
