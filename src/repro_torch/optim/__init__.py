from . import adamw
from .adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
