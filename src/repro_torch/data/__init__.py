from .pipeline import DataConfig, DataIterator, batch_at_step

__all__ = ["DataConfig", "DataIterator", "batch_at_step"]
