"""Shape-adaptive runtime autotuner (paper Fig. 10, beyond the paper).

The paper exposes exactly one tuning parameter — the tile size T — and
Fig. 10 shows L3 throughput is sharply sensitive to it: small tiles
under-saturate device and link (2T^3 flops vs 3T^2 bytes moved), big
tiles starve parallelism (Eq. 2), and the best T depends on the
routine, the problem shape and the device topology.  The repo's
scheduling knobs (``n_streams``, ``policy``) interact with T the same
way.  Instead of one fixed default, the :class:`Autotuner` closes the
loop at runtime:

1. bucket the problem shape (next power of two per dim) so one search
   covers a neighbourhood of shapes;
2. resolve the candidate ``(tile, n_streams, policy)`` configuration
   for the bucket under one of three **modes**:

   * ``"sweep"`` (default) — measure every candidate through
     **metadata-only shadow runs** (``execute=False``) on the
     discrete-event engine (``time_model="events"``) — full
     scheduling/cache/link behaviour, zero numerics, so a sweep costs
     milliseconds even at paper scale — and pick the argmin
     virtual-clock makespan (ties break toward the earlier candidate;
     the default config is always candidate zero, so the tuned pick
     can never be worse than the default under the same cost model);
   * ``"model"`` — predict every candidate's makespan with the
     learned :class:`~repro_torch.tuning.model.CostModel` (ridge regression
     in log space, trained on the rows earlier sweeps left in the
     cache) and **confirm** the predicted winner with measured shadow
     runs of the winner and the default; adopt only when the measured
     winner is ``<= default`` (so the guarantee stays measured, never
     predicted), else fall back to a full sweep;
   * ``"auto"`` — ``"model"`` when the model's residual-based
     prediction interval is tight (``rmse <= max_model_rmse`` on at
     least ``min_model_rows`` training rows), ``"sweep"`` otherwise.
     Cold caches bootstrap through sweeps; once enough evidence has
     accumulated, unseen buckets cost two confirmation runs instead
     of a full sweep (the long-tailed-traffic fix — see
     ``docs/TUNING.md``);

3. persist the winner in the :class:`~repro_torch.tuning.cache.TuningCache`
   keyed by ``topology fingerprint / backend / routine / shape bucket /
   dtype`` — later contexts (and processes, with a file-backed cache)
   start warm and never re-sweep.  Fitted model state persists in the
   same file.

Everything is virtual-clock deterministic: the same topology and shape
always produce the same pick, on any host (model predictions inherit
ordinary float arithmetic, but every adopted makespan is a measured,
deterministic shadow run).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import task as taskmod
from ..core.dtypes import dtype_name
from ..core.runtime import BlasxRuntime, RuntimeConfig
from ..core.tiling import ShadowMatrix
from . import model as modelmod
from .cache import TuningCache, resolve_cache

ROUTINES = ("gemm", "syrk", "syr2k", "symm", "trmm", "trsm")
MODES = ("sweep", "model", "auto")

# candidate tile sizes (paper Fig. 10 sweeps 256..4096; 128 covers the
# small-shape end the paper never ran)
DEFAULT_TILE_CANDIDATES = (128, 256, 512, 1024, 2048)
# stream counts worth trying: the paper's 4, the cublasxt-style 2, and
# a deeper pipe for link-bound shapes
DEFAULT_STREAM_CANDIDATES = (2, 4, 8)
# policies worth trying at runtime: the paper's contribution and the
# static speed-proportional split (which wins when stealing/priority
# overhead buys nothing, e.g. perfectly regular single-routine sweeps)
DEFAULT_POLICY_CANDIDATES = ("blasx", "static")
# taskization modes worth trying: owner (Eq. 2) and the Stream-K
# work-centric split (repro_torch.core.task.plan_work_centric) — the latter
# wins on small/ragged shapes where owner DoP underfills the machine
DEFAULT_WORK_CENTRIC_CANDIDATES = (False, True)

# shadow-run budget: skip candidate tiles whose taskization would
# schedule more than this many k-steps (a metadata sweep should stay
# in the milliseconds; the default tile is exempt so the baseline
# makespan always exists)
MAX_SHADOW_STEPS = 60_000
MIN_BUCKET = 64

# model path: only deviate from the default when the predicted win is
# at least this fraction — a hair-thin predicted improvement is inside
# the model's noise, and chasing it risks a confirmation-disproof
# (which costs a full sweep); predicting "the default is fine" costs
# one confirmation run and adopts trivially
MIN_PREDICTED_GAIN = 0.03


def shape_bucket(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """Round each dimension up to the next bucket edge (floor 64): one
    sweep serves every shape in the bucket.

    Edges are powers of two *plus their geometric midpoints*
    ``round(2^p / sqrt(2))``: pure next-power-of-two rounding aliased a
    4100^3 problem into the 8192^3 bucket — nearly 8x the FLOPs — so a
    sweep could crown a tile that loses at the true shape (the ragged
    regime of arXiv 2406.19621).  With the midpoint edge the worst-case
    per-dimension inflation drops from 2x to sqrt(2)x (<= ~2.83x in
    FLOPs for a cubic problem), while buckets stay coarse enough that
    one sweep still serves a neighbourhood of shapes.  Idempotent:
    ``up(up(x)) == up(x)``."""
    def up(x: int) -> int:
        p = 1 << max(0, math.ceil(math.log2(max(1, x))))
        half = round(p / math.sqrt(2))
        return max(MIN_BUCKET, half if x <= half else p)
    return (up(m), up(k), up(n))


def topology_fingerprint(cfg: RuntimeConfig) -> str:
    """Stable hash of the machine-describing config fields (see
    :meth:`RuntimeConfig.topology`)."""
    blob = json.dumps(cfg.topology(), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def cache_key(fingerprint: str, backend: str, routine: str,
              bucket: Tuple[int, int, int], dtype_name: str) -> str:
    m, k, n = bucket
    return f"{fingerprint}/{backend}/{routine}/{m}x{k}x{n}/{dtype_name}"


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """The autotuner's answer for one (routine, shape bucket, dtype)."""

    tile: int
    n_streams: int
    policy: str
    makespan: float           # winning virtual-clock makespan (seconds)
    default_makespan: float   # the fixed-default config's makespan
    source: str               # "swept" | "model" | "cache" | "cache-file"
    key: str = ""
    work_centric: bool = False  # Stream-K split taskization won

    @property
    def speedup_vs_default(self) -> float:
        return (self.default_makespan / self.makespan
                if self.makespan > 0 else 1.0)


def _shadow_tasks(routine: str, bucket: Tuple[int, int, int], tile: int,
                  dtype) -> Tuple[List, Dict[str, ShadowMatrix], str]:
    """Taskize one routine at bucket scale over shape-only matrices.
    Operand shapes mirror the context-layer calls (side='L', trans='N',
    uplo='U', beta=0 — the tuned knobs dominate the schedule, not the
    variant flags, and one canonical variant keeps sweeps cheap)."""
    m, k, n = bucket
    if routine == "gemm":
        mats = {"A": ShadowMatrix("A", m, k, tile, dtype=dtype),
                "B": ShadowMatrix("B", k, n, tile, dtype=dtype),
                "C": ShadowMatrix("C", m, n, tile, dtype=dtype)}
        tasks = taskmod.taskize_gemm(mats["A"].grid, mats["B"].grid,
                                     mats["C"].grid, "N", "N", 1.0, 0.0)
    elif routine == "syrk":
        mats = {"A": ShadowMatrix("A", n, k, tile, dtype=dtype),
                "C": ShadowMatrix("C", n, n, tile, dtype=dtype)}
        tasks = taskmod.taskize_syrk(mats["A"].grid, mats["C"].grid,
                                     "U", "N", 1.0, 0.0)
    elif routine == "syr2k":
        mats = {"A": ShadowMatrix("A", n, k, tile, dtype=dtype),
                "B": ShadowMatrix("B", n, k, tile, dtype=dtype),
                "C": ShadowMatrix("C", n, n, tile, dtype=dtype)}
        tasks = taskmod.taskize_syr2k(mats["A"].grid, mats["B"].grid,
                                      mats["C"].grid, "U", "N", 1.0, 0.0)
    elif routine == "symm":
        mats = {"A": ShadowMatrix("A", m, m, tile, dtype=dtype),
                "B": ShadowMatrix("B", m, n, tile, dtype=dtype),
                "C": ShadowMatrix("C", m, n, tile, dtype=dtype)}
        tasks = taskmod.taskize_symm(mats["A"].grid, mats["B"].grid,
                                     mats["C"].grid, "U", 1.0, 0.0)
    elif routine == "trmm":
        mats = {"A": ShadowMatrix("A", m, m, tile, dtype=dtype),
                "Cin": ShadowMatrix("Cin", m, n, tile, dtype=dtype),
                "C": ShadowMatrix("C", m, n, tile, dtype=dtype)}
        tasks = taskmod.taskize_trmm(mats["A"].grid, mats["Cin"].grid,
                                     mats["C"].grid, "U", "N", "N", 1.0)
    elif routine == "trsm":
        mats = {"A": ShadowMatrix("A", m, m, tile, dtype=dtype),
                "B": ShadowMatrix("B", m, n, tile, dtype=dtype),
                "C": ShadowMatrix("C", m, n, tile, dtype=dtype)}
        tasks = taskmod.taskize_trsm(mats["A"].grid, mats["B"].grid,
                                     mats["C"].grid, "U", "N", "N", 1.0)
    else:
        raise ValueError(f"unknown routine {routine!r} "
                         f"(expected one of {ROUTINES})")
    return tasks, mats, "C"


class Autotuner:
    """Per-topology configuration search over metadata shadow runs,
    optionally short-circuited by a learned cost model.

    Parameters
    ----------
    cfg:
        The base :class:`RuntimeConfig` — its topology fields define
        the fingerprint; its ``(n_streams, policy)`` plus
        ``default_tile`` form candidate zero (the fixed default every
        sweep is measured against).
    cache:
        ``None`` (process-shared), a path, or a
        :class:`~repro_torch.tuning.cache.TuningCache`.
    mode:
        ``"sweep"`` (exhaustive, the default), ``"model"`` (always
        trust a trained cost model, confirmation-checked), or
        ``"auto"`` (model when its uncertainty is tight, sweep
        otherwise).  See the module docstring.
    tiles / streams / policies:
        Candidate overrides (benchmark lanes restrict these to bound
        sweep cost).
    default_tile:
        The stack-wide fixed default (``repro_torch.api.context.DEFAULT_TILE``
        unless told otherwise).
    min_model_rows / max_model_rmse:
        The ``auto``-mode trust gate: the model must have fit at least
        this many measured rows with a log-residual RMSE at most this
        wide before its predictions replace a sweep.
    """

    def __init__(self, cfg: RuntimeConfig, cache=None, *,
                 mode: str = "sweep",
                 tiles: Sequence[int] = DEFAULT_TILE_CANDIDATES,
                 streams: Sequence[int] = DEFAULT_STREAM_CANDIDATES,
                 policies: Sequence[str] = DEFAULT_POLICY_CANDIDATES,
                 work_centric: Sequence[bool] =
                 DEFAULT_WORK_CENTRIC_CANDIDATES,
                 default_tile: int = 256,
                 min_model_rows: int = modelmod.MIN_ROWS,
                 max_model_rmse: float = modelmod.MAX_RMSE):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.cfg = cfg
        self.cache: TuningCache = resolve_cache(cache)
        self.mode = mode
        self.fingerprint = topology_fingerprint(cfg)
        self.tiles = tuple(tiles)
        self.streams = tuple(streams)
        self.policies = tuple(policies)
        self.work_centric = tuple(bool(w) for w in work_centric)
        self.default_tile = int(default_tile)
        self.min_model_rows = int(min_model_rows)
        self.max_model_rmse = float(max_model_rmse)
        self.sweeps = 0          # shadow runs performed by THIS tuner
        self.bucket_sweeps = 0   # full per-bucket sweeps
        self.confirmations = 0   # model-path confirmation shadow runs
        self.cache_hits = 0      # total (file + process)
        self.file_cache_hits = 0
        self.process_cache_hits = 0
        self.model_adoptions = 0
        self.model_fallbacks = 0  # trained model declined or disproved
        self._events: List[dict] = []   # tuning_report raw material
        self._model: Optional[modelmod.CostModel] = None
        self._model_version = -1        # cache.version the fit saw
        # bootstrap from persisted state so a fresh process predicts
        # before its first in-process sweep (refit on first staleness)
        state = self.cache.model_state()
        if state is not None:
            m = modelmod.CostModel.from_state(state)
            if m.trained:
                self._model = m
                self._model_version = self.cache.version

    # ------------------------------------------------------------ search
    def tune(self, routine: str, m: int, k: Optional[int] = None,
             n: Optional[int] = None, dtype="float64") -> TunedConfig:
        """Return the tuned config for one problem (cache hit, model
        prediction + confirmation, or full sweep — see the class
        docstring for the mode semantics)."""
        k = m if k is None else k
        n = m if n is None else n
        bucket = shape_bucket(m, k, n)
        dt_name = dtype_name(dtype)
        key = cache_key(self.fingerprint, self.cfg.backend, routine,
                        bucket, dt_name)
        entry = self.cache.get(key)
        if entry is not None and entry.get("space") != self._space():
            # the entry was swept against a DIFFERENT default config or
            # candidate space (e.g. a bench lane's restricted tiles):
            # its default_makespan is not this tuner's default and its
            # argmin never saw this tuner's candidates, so the
            # tuned<=default guarantee would silently stop holding.
            # Treat as a miss and re-sweep (the fresh entry overwrites).
            entry = None
        if entry is not None:
            origin = self.cache.origin(key) or "process"
            self.cache_hits += 1
            if origin == "file":
                self.file_cache_hits += 1
            else:
                self.process_cache_hits += 1
            source = "cache-file" if origin == "file" else "cache"
            best = TunedConfig(tile=entry["tile"],
                               n_streams=entry["n_streams"],
                               policy=entry["policy"],
                               makespan=entry["makespan"],
                               default_makespan=entry["default_makespan"],
                               source=source, key=key,
                               work_centric=bool(
                                   entry.get("work_centric", False)))
            self._events.append({"key": key, "source": source,
                                 "swept": 0, **entry})
            return best
        candidates = self._candidates(routine, bucket)
        if self.mode in ("model", "auto"):
            best = self._model_tune(routine, bucket, dt_name, key,
                                    candidates)
            if best is not None:
                return best
        return self._sweep(routine, bucket, dt_name, key, candidates)

    # --------------------------------------------------------- sweep path
    def _sweep(self, routine: str, bucket: Tuple[int, int, int],
               dt_name: str, key: str,
               candidates: List[Tuple[int, int, str, bool]]) -> TunedConfig:
        results = []
        for tile, ns, policy, wc in candidates:
            span = self._shadow_makespan(routine, bucket, tile, dt_name,
                                         ns, policy, wc)
            self.sweeps += 1
            results.append({"tile": tile, "n_streams": ns,
                            "policy": policy, "work_centric": wc,
                            "makespan": span})
        self.bucket_sweeps += 1
        # candidate zero IS the fixed default: the argmin can therefore
        # never be worse than it (the acceptance invariant)
        default_span = results[0]["makespan"]
        best_row = min(results, key=lambda r: r["makespan"])
        entry = self._entry(routine, bucket, dt_name, best_row,
                            default_span, results)
        self.cache.put(key, entry)
        self._events.append({"key": key, "source": "swept",
                             "swept": len(results), **entry})
        return TunedConfig(tile=best_row["tile"],
                           n_streams=best_row["n_streams"],
                           policy=best_row["policy"],
                           makespan=best_row["makespan"],
                           default_makespan=default_span,
                           source="swept", key=key,
                           work_centric=best_row["work_centric"])

    # --------------------------------------------------------- model path
    def _ensure_model(self) -> Optional[modelmod.CostModel]:
        """The cost model fitted against the cache's current rows
        (refit whenever the cache version moved); persisted back into
        the cache so file-backed caches carry their model with them."""
        if self._model is not None and \
                self._model_version == self.cache.version:
            return self._model
        rows = modelmod.training_rows(self.cache, self.fingerprint,
                                      self.cfg.backend,
                                      self.cfg.topology())
        model = modelmod.CostModel().fit(rows)
        self._model = model if model.trained else None
        self._model_version = self.cache.version
        if model.trained:
            self.cache.set_model_state(model.state())
        return self._model

    def _model_tune(self, routine: str, bucket: Tuple[int, int, int],
                    dt_name: str, key: str,
                    candidates: List[Tuple[int, int, str]]
                    ) -> Optional[TunedConfig]:
        """Predict per-candidate makespans, confirm the predicted
        winner against the measured default, adopt on success.  Returns
        ``None`` to fall back to the sweep (cold/untrusted model, or
        the confirmation disproved the prediction)."""
        model = self._ensure_model()
        if model is None:
            # nothing to learn from yet: bootstrap through a sweep
            # (whose rows become the training set)
            self.model_fallbacks += 1
            self._events.append({"key": key, "source": "model-fallback",
                                 "reason": "untrained"})
            return None
        trusted = (model.n_rows >= self.min_model_rows
                   and model.rmse <= self.max_model_rmse)
        if self.mode == "auto" and not trusted:
            self.model_fallbacks += 1
            self._events.append({
                "key": key, "source": "model-fallback",
                "reason": "untrusted",
                "model_rmse": model.rmse, "model_rows": model.n_rows})
            return None
        topo = self.cfg.topology()
        preds = [model.predict(modelmod.features(
            routine, bucket, dt_name, topo, tile, ns, policy,
            work_centric=wc))
            for tile, ns, policy, wc in candidates]
        win_idx = min(range(len(preds)), key=preds.__getitem__)
        if preds[win_idx] >= preds[0] * (1 - MIN_PREDICTED_GAIN):
            win_idx = 0          # predicted win is inside model noise
        winner, default = candidates[win_idx], candidates[0]
        # single confirmation run of the predicted winner; the measured
        # default is the other half of the tuned<=default guarantee
        # (free when the model already picked the default itself)
        win_span = self._shadow_makespan(routine, bucket, winner[0],
                                         dt_name, winner[1], winner[2],
                                         winner[3])
        self.sweeps += 1
        self.confirmations += 1
        if winner == default:
            default_span = win_span
            measured = [{"tile": winner[0], "n_streams": winner[1],
                         "policy": winner[2], "work_centric": winner[3],
                         "makespan": win_span}]
        else:
            default_span = self._shadow_makespan(
                routine, bucket, default[0], dt_name, default[1],
                default[2], default[3])
            self.sweeps += 1
            self.confirmations += 1
            measured = [
                {"tile": default[0], "n_streams": default[1],
                 "policy": default[2], "work_centric": default[3],
                 "makespan": default_span},
                {"tile": winner[0], "n_streams": winner[1],
                 "policy": winner[2], "work_centric": winner[3],
                 "makespan": win_span},
            ]
        if win_span > default_span * (1 + 1e-12):
            # prediction disproved by measurement: the guarantee is
            # measured, so fall back to the full sweep (whose rows also
            # enrich the training set exactly where the model was wrong)
            self.model_fallbacks += 1
            self._events.append({
                "key": key, "source": "model-fallback",
                "reason": "confirmation",
                "predicted_makespan": preds[win_idx],
                "measured_makespan": win_span,
                "default_makespan": default_span})
            return None
        best_row = {"tile": winner[0], "n_streams": winner[1],
                    "policy": winner[2], "work_centric": winner[3],
                    "makespan": win_span}
        # only MEASURED rows enter "candidates" (the training set);
        # predictions ride along separately for introspection
        entry = self._entry(routine, bucket, dt_name, best_row,
                            default_span, measured)
        entry["predicted"] = {
            "winner_makespan": preds[win_idx],
            "default_makespan": preds[0],
            "model_rmse": model.rmse, "model_rows": model.n_rows,
        }
        self.cache.put(key, entry)
        self.model_adoptions += 1
        self._events.append({"key": key, "source": "model",
                             "swept": len(measured), **entry})
        return TunedConfig(tile=winner[0], n_streams=winner[1],
                           policy=winner[2], makespan=win_span,
                           default_makespan=default_span,
                           source="model", key=key,
                           work_centric=winner[3])

    # ------------------------------------------------------------ helpers
    def _entry(self, routine: str, bucket: Tuple[int, int, int],
               dt_name: str, best_row: dict, default_span: float,
               measured: List[dict]) -> dict:
        return {
            "routine": routine, "bucket": list(bucket), "dtype": dt_name,
            "tile": best_row["tile"], "n_streams": best_row["n_streams"],
            "policy": best_row["policy"],
            "work_centric": best_row.get("work_centric", False),
            "makespan": best_row["makespan"],
            "default_makespan": default_span,
            "candidates": measured,
            "space": self._space(),
            "topology": self.cfg.topology(),
        }

    def _space(self) -> dict:
        """What a cached entry's verdict depends on besides the key:
        the default config it was measured against and the candidate
        space its argmin saw.  Hits require an exact match — a tuner
        with a different default tile / streams / policy or a wider
        candidate set must re-sweep, or 'tuned never worse than
        default' would quietly refer to someone else's default."""
        return {
            "default": [self.default_tile, self.cfg.n_streams,
                        self.cfg.policy, bool(self.cfg.work_centric)],
            "tiles": list(self.tiles),
            "streams": list(self.streams),
            "policies": list(self.policies),
            "work_centric": list(self.work_centric),
        }

    def _candidates(self, routine: str,
                    bucket: Tuple[int, int, int]
                    ) -> List[Tuple[int, int, str, bool]]:
        """Ordered candidate list; the fixed default config comes first
        and is never budget-filtered."""
        m, k, n = bucket
        default = (self.default_tile, self.cfg.n_streams, self.cfg.policy,
                   bool(self.cfg.work_centric))
        out = [default]
        capacity = self.cfg.n_devices * self.cfg.effective_streams
        for tile in self.tiles:
            if tile > max(m, k, n):
                continue            # degenerate: one tile holds everything
            for wc in self.work_centric:
                if self._step_estimate(routine, bucket, tile,
                                       work_centric=wc,
                                       capacity=capacity) > MAX_SHADOW_STEPS:
                    continue        # sweep budget: skip pathological grids
                for ns in self.streams:
                    for policy in self.policies:
                        cand = (tile, ns, policy, bool(wc))
                        if cand != default and cand not in out:
                            out.append(cand)
        return out

    @staticmethod
    def _step_estimate(routine: str, bucket: Tuple[int, int, int],
                       tile: int, work_centric: bool = False,
                       capacity: int = 8) -> int:
        """Scheduled k-step count of one candidate taskization — the
        sweep-budget yardstick and (mirrored in ``repro_torch.tuning.model``)
        the cost model's ``lsteps`` feature.  Under the work-centric
        mode every split tile re-walks its k-loop once more (the
        partials' slices plus the fix-up's full re-dispatch), mirroring
        :func:`repro_torch.core.tiling.workcentric_parts`: all tiles split on
        small problems (owner count below ``capacity``), only ragged
        boundary tiles split on large ones."""
        m, k, n = bucket
        rows = math.ceil(m / tile)
        cols = math.ceil(n / tile)
        depth = math.ceil(k / tile)
        factor = 1
        if routine in ("syrk", "syr2k"):
            rows = cols = math.ceil(n / tile)
            ntasks = rows * (rows + 1) // 2
            factor = 2 if routine == "syr2k" else 1
            interior = (n // tile) * ((n // tile) + 1) // 2
        else:
            if routine in ("symm", "trmm", "trsm"):
                depth = math.ceil(m / tile)
            ntasks = rows * cols
            interior = (m // tile) * (n // tile)
        base = ntasks * depth * factor
        if not work_centric or depth * factor < 2:
            return base
        split = ntasks if ntasks < capacity else max(0, ntasks - interior)
        return base + split * depth * factor

    def _shadow_makespan(self, routine: str, bucket: Tuple[int, int, int],
                         tile: int, dtype: str, n_streams: int,
                         policy: str, work_centric: bool = False) -> float:
        """One metadata-only run of (routine, bucket) under a candidate
        config; returns the virtual-clock makespan.  Nothing executes,
        so the shadow runtime stays on the host whatever the context's
        device."""
        cfg = dataclasses.replace(
            self.cfg, mode="sim", time_model="events", execute=False,
            record_trace=False, n_streams=n_streams, rs_slots=None,
            policy=policy, work_centric=work_centric, device="cpu")
        tasks, mats, out_id = _shadow_tasks(routine, bucket, tile, dtype)
        rt = BlasxRuntime(cfg)
        rt.run(tasks, mats, out_id)
        return rt.makespan()

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """Introspection surface behind ``ctx.tuning_report()``."""
        model = self._model
        return {
            "mode": self.mode,
            "fingerprint": self.fingerprint,
            "backend": self.cfg.backend,
            "cache_path": self.cache.path,
            "cache_entries": len(self.cache),
            "sweeps": self.sweeps,
            "bucket_sweeps": self.bucket_sweeps,
            "confirmations": self.confirmations,
            "cache_hits": self.cache_hits,
            "file_cache_hits": self.file_cache_hits,
            "process_cache_hits": self.process_cache_hits,
            "model_adoptions": self.model_adoptions,
            "model_fallbacks": self.model_fallbacks,
            "model": ({"trained": True, "n_rows": model.n_rows,
                       "rmse": model.rmse}
                      if model is not None and model.trained
                      else {"trained": False, "n_rows": 0,
                            "rmse": None}),
            "tile_candidates": list(self.tiles),
            "stream_candidates": list(self.streams),
            "policy_candidates": list(self.policies),
            "work_centric_candidates": list(self.work_centric),
            "entries": [dict(e) for e in self._events],
        }
