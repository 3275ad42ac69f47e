"""Persistent tuning cache — the autotuner's memory (and, since the
learned cost model landed, its training set).

One entry per ``(topology fingerprint, backend, routine, shape bucket,
dtype)`` key, holding the winning ``(tile, n_streams, policy)`` plus
the shadow-run evidence (per-candidate virtual-clock makespans — which
doubles as the :mod:`repro_torch.tuning.model` training data).  Entries
live in process memory and, when a path is configured, in a JSON file
so the search runs once per machine — every later ``BlasxContext`` (or
process) starts warm and performs **zero** shadow-run sweeps for known
keys.  The fitted :class:`~repro_torch.tuning.model.CostModel` state
persists in the same file (``"model"`` key) next to the entries it was
trained on.

Resolution order for the backing file:

* an explicit ``path=`` (``BlasxContext(tuning_cache="...")``,
  ``TuningCache("...")``; the empty string ``""`` forces memory-only
  even when the environment variable is set),
* else the ``BLASX_TORCH_TUNING_CACHE`` environment variable,
* else memory-only (no file is ever written).

The port has its own variable and its own process-wide cache, apart
from the reference package's ``BLASX_TUNING_CACHE``: both packages
fingerprint the same topology dict, so a shared file would hand each
one the other's verdicts.

``shared_cache()`` returns the process-wide instance used by default:
two contexts with the same topology share it, which is what makes the
second context a pure cache hit.

Every entry also carries a **provenance** tag — ``"file"`` when it was
loaded from a backing file, ``"process"`` when it was put by this
process — surfaced through :meth:`TuningCache.origin` so
``ctx.tuning_report()`` can split cache hits into file-cache vs
process-cache hits.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

ENV_CACHE_PATH = "BLASX_TORCH_TUNING_CACHE"
CACHE_SCHEMA = 1


class _CacheBook:
    """The entries, provenance tags, model state and counters of one
    :class:`TuningCache`, under one reentrant lock (held through a file
    write, so concurrent puts cannot interleave on one tmp file).

    A class of its own rather than fields of ``TuningCache`` because
    the reference's lock-order lint (``repro.analysis``) keys
    lock-owning classes by their bare name: a port class named
    ``TuningCache`` that declared a lock would take the place of the
    reference's cache in that graph.  Its methods are named so that
    the lint's by-name call resolution cannot confuse them with another
    class's.
    """

    _GUARDED_BY = {"_lock": (
        "_entries", "_origins", "_model_state", "_version", "_hits",
        "_misses")}

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: Dict[str, dict] = {}
        self._origins: Dict[str, str] = {}     # key -> "file" | "process"
        self._model_state: Optional[dict] = None
        self._version = 0
        self._hits = 0
        self._misses = 0

    def counters(self):
        """``(version, hits, misses)``."""
        with self._lock:
            return self._version, self._hits, self._misses

    def entry_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def sorted_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def lookup(self, key: str) -> Optional[dict]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            self._hits += 1
            return dict(entry)

    def origin_of(self, key: str) -> Optional[str]:
        with self._lock:
            return self._origins.get(key)

    def copy_entries(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def store_entry(self, key: str, entry: dict,
                    path: Optional[str]) -> None:
        with self._lock:
            self._entries[key] = dict(entry)
            self._origins[key] = "process"
            self._version += 1
            if path:
                self.write_json(path)

    def copy_model(self) -> Optional[dict]:
        with self._lock:
            return dict(self._model_state) if self._model_state else None

    def store_model(self, state: Optional[dict],
                    path: Optional[str]) -> None:
        with self._lock:
            self._model_state = dict(state) if state else None
            if path:
                self.write_json(path)

    def merge_loaded(self, entries: Dict[str, dict],
                     model: Optional[dict]) -> int:
        with self._lock:
            self._entries.update(entries)
            for key in entries:
                self._origins[key] = "file"
            if isinstance(model, dict):
                self._model_state = model
            self._version += 1
            return len(entries)

    def write_json(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with self._lock:
            payload = {"schema": CACHE_SCHEMA, "entries": self._entries}
            if self._model_state:
                payload["model"] = self._model_state
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)

    def wipe(self) -> None:
        with self._lock:
            self._entries = {}
            self._origins = {}
            self._model_state = None
            self._version += 1
            self._hits = 0
            self._misses = 0


class TuningCache:
    """Thread-safe key -> entry store with optional JSON persistence.

    Entries are plain dicts (JSON-serializable); the autotuner owns
    their shape.  ``hits``/``misses`` count lookups for the
    ``tuning_report`` surface; ``version`` increments on every
    mutation so the cost model knows when its training set went stale.
    """

    def __init__(self, path: Optional[str] = None):
        # path="" is an explicit memory-only override (no env fallback)
        self.path = (path or None) if path is not None else \
            os.environ.get(ENV_CACHE_PATH) or None
        self._book = _CacheBook()
        if self.path and os.path.exists(self.path):
            self.load(self.path)

    @property
    def version(self) -> int:
        return self._book.counters()[0]

    @property
    def hits(self) -> int:
        return self._book.counters()[1]

    @property
    def misses(self) -> int:
        return self._book.counters()[2]

    def __len__(self) -> int:
        return self._book.entry_count()

    def keys(self) -> List[str]:
        return self._book.sorted_keys()

    def get(self, key: str) -> Optional[dict]:
        return self._book.lookup(key)

    def origin(self, key: str) -> Optional[str]:
        """``"file"`` if the entry came from a backing file,
        ``"process"`` if it was put by this process, ``None`` when the
        key is absent.  Does not touch the hit/miss counters."""
        return self._book.origin_of(key)

    def snapshot(self) -> Dict[str, dict]:
        """Copy of every entry, without touching the hit/miss counters
        (the cost model iterates this to build its training set)."""
        return self._book.copy_entries()

    def put(self, key: str, entry: dict) -> None:
        """Store an entry and persist immediately when file-backed (a
        crash between sweeps then loses at most nothing)."""
        self._book.store_entry(key, entry, self.path)

    # -------------------------------------------------- model persistence
    def model_state(self) -> Optional[dict]:
        """The persisted :class:`~repro_torch.tuning.model.CostModel`
        state (or ``None``); loaded from / saved to the same JSON file
        as the entries."""
        return self._book.copy_model()

    def set_model_state(self, state: Optional[dict]) -> None:
        """Attach fitted cost-model state; persisted on the next (or,
        when file-backed, this) save."""
        self._book.store_model(state, self.path)

    def load(self, path: str) -> int:
        """Merge entries (and any persisted model state) from a JSON
        cache file; returns how many entries were loaded.  Unknown
        schemas and unreadable/corrupt files are ignored rather than
        trusted — a damaged cache degrades to a re-sweep, never to a
        crash loop at context construction."""
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return 0
        if not isinstance(data, dict) or data.get("schema") != CACHE_SCHEMA:
            return 0
        entries = data.get("entries", {})
        if not isinstance(entries, dict):
            return 0
        return self._book.merge_loaded(entries, data.get("model"))

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("TuningCache has no backing path")
        self._book.write_json(path)
        return path

    def clear(self) -> None:
        self._book.wipe()


# --------------------------------------------------- process-shared default
_shared: Optional[TuningCache] = None
_shared_lock = threading.Lock()


def shared_cache() -> TuningCache:
    """The port's process-wide default cache (memory-backed unless
    ``BLASX_TORCH_TUNING_CACHE`` is set): every
    ``BlasxContext(auto_tune=True)`` without an explicit
    ``tuning_cache=`` shares it."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = TuningCache()
        return _shared


def reset_shared_cache() -> None:
    """Drop the process-wide cache (test isolation)."""
    global _shared
    with _shared_lock:
        _shared = None


def resolve_cache(spec) -> TuningCache:
    """``None`` -> process-shared, ``str`` -> file-backed (``""`` ->
    memory-only), instance -> itself (the ``tuning_cache=`` coercion
    used by the context layer)."""
    if spec is None:
        return shared_cache()
    if isinstance(spec, TuningCache):
        return spec
    if isinstance(spec, (str, os.PathLike)):
        return TuningCache(os.fspath(spec))
    raise TypeError(f"tuning_cache must be None, a path or a TuningCache, "
                    f"got {type(spec).__name__}")
