"""repro_torch.tuning — shape-adaptive runtime autotuning (paper Fig. 10).

Sweeps candidate ``(tile, n_streams, policy)`` configurations through
metadata-only shadow runs on the discrete-event virtual clock and
caches the winner per ``(topology fingerprint, backend, routine, shape
bucket, dtype)``.  A learned cost model (``repro_torch.tuning.model``, ridge
regression on log-space features trained on the cache's own sweep
rows) can replace the sweep for unseen buckets: ``mode="auto"``
predicts per-candidate makespans, confirms the predicted winner
against the measured default in one shadow run, and falls back to the
full sweep when the model is untrained/untrusted or disproved.  Wired
into the API stack via ``BlasxContext(auto_tune=True | "auto")`` and
``tile="auto"`` on every surface; see ``docs/TUNING.md`` for the cache
layout and decision flow.
"""
from .autotuner import (MODES, Autotuner, TunedConfig, cache_key,
                        shape_bucket, topology_fingerprint)
from .cache import (ENV_CACHE_PATH, TuningCache, reset_shared_cache,
                    resolve_cache, shared_cache)
from .model import CostModel, feature_names, features, training_rows

__all__ = [
    "Autotuner", "TunedConfig", "TuningCache", "MODES",
    "shape_bucket", "topology_fingerprint", "cache_key",
    "shared_cache", "reset_shared_cache", "resolve_cache",
    "ENV_CACHE_PATH",
    "CostModel", "features", "feature_names", "training_rows",
]
