"""Learned cost model for the runtime autotuner (beyond the paper).

The sweep-based :class:`~repro_torch.tuning.autotuner.Autotuner` pays one
metadata shadow run per candidate for every cold ``(routine, shape
bucket, dtype)`` — the right cost structure for a handful of shapes,
the wrong one for serving traffic whose shape distribution is ragged
and long-tailed (every new bucket is a full sweep).  Following the
direction of "Machine-Learning-Driven Runtime Optimization of BLAS
Level 3" (arXiv 2406.19621), this module learns the sweep's cost
function instead of re-measuring it:

* **training data** — the rows the
  :class:`~repro_torch.tuning.cache.TuningCache` already accumulates: every
  swept entry stores *all* candidate makespans, so one 13-candidate
  sweep contributes 13 labeled examples for free (model-adopted
  entries contribute only their *measured* confirmation rows — the
  model never trains on its own predictions);
* **features** — log-space shape/bucket dims and aspect ratios, dtype
  itemsize, routine and policy one-hots, candidate ``tile`` /
  ``n_streams`` (with quadratic tile terms, because Fig. 10's
  makespan-vs-tile curve is U-shaped and a purely linear model in
  ``log tile`` could never have an interior argmin), a per-routine
  step-count estimate, and the topology-fingerprint fields
  (:meth:`~repro_torch.core.runtime.RuntimeConfig.topology`);
* **model** — ridge regression on standardized features predicting
  ``log(makespan)``, solved in closed form with numpy: dependency-free,
  deterministic, microseconds to fit at tuning-cache scale;
* **uncertainty** — a residual-based prediction interval: the
  training-residual RMSE in log space (degrees-of-freedom corrected).
  The autotuner's ``auto`` mode only trusts the model when this
  interval is tight (``rmse <= max_rmse`` with ``n_rows >= min_rows``)
  *and* the predicted winner shadow-verifies ``<= default`` in a
  confirmation run — the tuned-never-worse-than-default guarantee is
  enforced on measured makespans, never on predictions.

Model state (coefficients, scaler, residual stats) round-trips through
:meth:`CostModel.state` / :meth:`CostModel.from_state` and persists
inside the tuning-cache JSON file next to the entries it was fitted
on (see :meth:`~repro_torch.tuning.cache.TuningCache.set_model_state`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.dtypes import canonical_dtype

# one-hot vocabularies are fixed so feature vectors are stable across
# processes (the model state persists; an open vocabulary would shift
# column meanings between fit and predict)
ROUTINES = ("gemm", "syrk", "syr2k", "symm", "trmm", "trsm")
POLICIES = ("blasx", "parsec", "cublasxt", "static")

# auto-mode trust gate defaults (Autotuner can override): the model is
# only consulted once it has seen at least MIN_ROWS measured candidate
# rows and its dof-corrected log-residual RMSE is below MAX_RMSE
# (0.35 in log space ~= a +-42% one-sigma band — loose enough to admit
# a freshly bootstrapped model, and safe because every adoption is
# still confirmed against a measured default makespan)
MIN_ROWS = 24
MAX_RMSE = 0.35


def _step_estimate(routine: str, bucket, tile: int,
                   work_centric: bool = False, capacity: int = 8) -> int:
    """Per-routine tile-task k-step count (mirrors
    ``Autotuner._step_estimate``; duplicated here so the model module
    stays importable without the tuner).  Under the work-centric mode
    every split tile re-walks its k-loop once more — the partials'
    slices plus the fix-up's full re-dispatch — mirroring
    ``repro_torch.core.tiling.workcentric_parts``: all tiles split on small
    problems (owner count below ``capacity``), only ragged boundary
    tiles split on large ones."""
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


def feature_names(topology: Dict[str, object]) -> List[str]:
    """Stable feature ordering for a given topology field set."""
    names = ["lm", "lk", "ln", "aspect_mn", "aspect_mk", "litemsize",
             "ltile", "ltile2", "ltile_x_dims", "lstreams", "lstreams2",
             "lsteps", "work_centric"]
    names += [f"routine_{r}" for r in ROUTINES]
    names += [f"policy_{p}" for p in POLICIES]
    names += [f"topo_{k}" for k in sorted(topology)
              if isinstance(topology[k], (int, float, bool))]
    return names


def features(routine: str, bucket, dtype_name: str,
             topology: Dict[str, object], tile: int, n_streams: int,
             policy: str, work_centric: bool = False) -> Dict[str, float]:
    """One feature dict for a (problem, candidate) pair.

    Everything multiplicative lives in log2 space — makespan is
    roughly a product of work, granularity and machine terms, so its
    log is roughly linear in these.  ``ltile2`` and ``ltile_x_dims``
    give the regression the curvature to place Fig. 10's interior
    optimum; ``lsteps`` encodes the routine-specific task count the
    schedule actually dispatches (partial-k tasks included when the
    candidate runs work-centric — owner-only counting would blind the
    model exactly on the small/ragged shapes the mode targets)."""
    m, k, n = bucket
    lm, lk, ln = math.log2(m), math.log2(k), math.log2(n)
    lt = math.log2(tile)
    ls = math.log2(max(1, n_streams))
    n_devices = topology.get("n_devices", 2)
    capacity = max(1, int(n_devices) * max(1, n_streams))
    out: Dict[str, float] = {
        "lm": lm, "lk": lk, "ln": ln,
        "aspect_mn": lm - ln, "aspect_mk": lm - lk,
        "litemsize": math.log2(canonical_dtype(dtype_name).itemsize),
        "ltile": lt, "ltile2": lt * lt,
        "ltile_x_dims": lt * (lm + lk + ln) / 3.0,
        "lstreams": ls, "lstreams2": ls * ls,
        "lsteps": math.log2(max(1, _step_estimate(
            routine, bucket, tile, work_centric=work_centric,
            capacity=capacity))),
        "work_centric": 1.0 if work_centric else 0.0,
    }
    for r in ROUTINES:
        out[f"routine_{r}"] = 1.0 if routine == r else 0.0
    for p in POLICIES:
        out[f"policy_{p}"] = 1.0 if policy == p else 0.0
    for key in sorted(topology):
        v = topology[key]
        if isinstance(v, bool):
            out[f"topo_{key}"] = 1.0 if v else 0.0
        elif isinstance(v, (int, float)):
            out[f"topo_{key}"] = math.log2(v) if v > 0 else float(v)
    return out


def training_rows(cache, fingerprint: str, backend: str,
                  topology: Dict[str, object]) -> List[Dict[str, object]]:
    """Extract (features, log-makespan) training rows from every cache
    entry under this tuner's ``fingerprint/backend`` namespace.

    Only *measured* candidate rows are used — swept entries carry the
    whole sweep, model-adopted entries carry just their confirmation
    runs — so the model never fits its own predictions.  Entries
    missing a stored topology (pre-model cache files) fall back to the
    caller's: the key prefix already guarantees the fingerprint
    matches."""
    prefix = f"{fingerprint}/{backend}/"
    rows: List[Dict[str, object]] = []
    for key, entry in cache.snapshot().items():
        if not key.startswith(prefix):
            continue
        routine = entry.get("routine")
        bucket = entry.get("bucket")
        dtype_name = entry.get("dtype")
        if routine not in ROUTINES or not bucket or not dtype_name:
            continue
        topo = entry.get("topology") or topology
        for cand in entry.get("candidates", ()):
            span = cand.get("makespan")
            if not span or span <= 0 or cand.get("policy") not in POLICIES:
                continue
            rows.append({
                "features": features(routine, tuple(bucket), dtype_name,
                                     topo, cand["tile"], cand["n_streams"],
                                     cand["policy"],
                                     work_centric=bool(
                                         cand.get("work_centric", False))),
                "log_makespan": math.log(span),
            })
    return rows


class CostModel:
    """Ridge regression on log-space features -> log(makespan).

    Closed-form fit (``(X'X + lam*n*I)^-1 X'y`` on standardized
    columns), so training is deterministic and costs microseconds at
    tuning-cache scale.  ``rmse`` is the degrees-of-freedom-corrected
    training-residual RMSE in log space — the residual-based
    prediction-interval width the autotuner's trust gate checks."""

    STATE_SCHEMA = 1

    def __init__(self, ridge_lambda: float = 1e-3):
        self.ridge_lambda = float(ridge_lambda)
        self.names: List[str] = []
        self.mean: Optional[np.ndarray] = None
        self.scale: Optional[np.ndarray] = None
        self.coef: Optional[np.ndarray] = None
        self.intercept: float = 0.0
        self.rmse: float = float("inf")
        self.n_rows: int = 0

    @property
    def trained(self) -> bool:
        return self.coef is not None

    def fit(self, rows: Sequence[Dict[str, object]]) -> "CostModel":
        """Fit on ``training_rows`` output; a no-op (untrained model)
        when there are fewer rows than features would make the solve
        meaningful."""
        if not rows:
            return self
        self.names = sorted(rows[0]["features"])
        X = np.array([[r["features"].get(name, 0.0) for name in self.names]
                      for r in rows], dtype=np.float64)
        y = np.array([r["log_makespan"] for r in rows], dtype=np.float64)
        n, d = X.shape
        self.mean = X.mean(axis=0)
        std = X.std(axis=0)
        # constant columns (e.g. topology fields under one fingerprint)
        # carry no information: scale 1 keeps them harmlessly at zero
        self.scale = np.where(std > 0, std, 1.0)
        Xs = (X - self.mean) / self.scale
        self.intercept = float(y.mean())
        yc = y - self.intercept
        lam = self.ridge_lambda * n
        A = Xs.T @ Xs + lam * np.eye(d)
        self.coef = np.linalg.solve(A, Xs.T @ yc)
        resid = Xs @ self.coef - yc
        dof = max(1, n - d)
        self.rmse = float(np.sqrt(float(resid @ resid) / n) *
                          math.sqrt(n / dof)) if n > d else float("inf")
        self.n_rows = n
        return self

    def predict(self, feats: Dict[str, float]) -> float:
        """Predicted makespan in (virtual-clock) seconds."""
        if not self.trained:
            raise RuntimeError("CostModel is not trained")
        x = np.array([feats.get(name, 0.0) for name in self.names],
                     dtype=np.float64)
        xs = (x - self.mean) / self.scale
        return math.exp(self.intercept + float(xs @ self.coef))

    def interval(self, feats: Dict[str, float],
                 z: float = 1.0) -> tuple:
        """Residual-based prediction interval ``(lo, hi)`` in seconds:
        the point prediction times ``exp(+-z * rmse)``."""
        p = self.predict(feats)
        half = z * (self.rmse if math.isfinite(self.rmse) else 10.0)
        return (p * math.exp(-half), p * math.exp(half))

    # ------------------------------------------------------- persistence
    def state(self) -> dict:
        """JSON-serializable model state (persisted inside the tuning
        cache file by the autotuner)."""
        if not self.trained:
            return {"schema": self.STATE_SCHEMA, "trained": False}
        return {
            "schema": self.STATE_SCHEMA,
            "trained": True,
            "ridge_lambda": self.ridge_lambda,
            "feature_names": list(self.names),
            "mean": [float(v) for v in self.mean],
            "scale": [float(v) for v in self.scale],
            "coef": [float(v) for v in self.coef],
            "intercept": self.intercept,
            "rmse": self.rmse,
            "n_rows": self.n_rows,
        }

    @classmethod
    def from_state(cls, state: Optional[dict]) -> "CostModel":
        """Rebuild from :meth:`state` output; malformed/foreign state
        degrades to an untrained model (the tuner then refits from the
        cache rows — never a crash)."""
        model = cls()
        if (not isinstance(state, dict)
                or state.get("schema") != cls.STATE_SCHEMA
                or not state.get("trained")):
            return model
        try:
            model.ridge_lambda = float(state["ridge_lambda"])
            model.names = list(state["feature_names"])
            model.mean = np.asarray(state["mean"], dtype=np.float64)
            model.scale = np.asarray(state["scale"], dtype=np.float64)
            model.coef = np.asarray(state["coef"], dtype=np.float64)
            model.intercept = float(state["intercept"])
            model.rmse = float(state["rmse"])
            model.n_rows = int(state["n_rows"])
            if not (len(model.names) == model.mean.size == model.scale.size
                    == model.coef.size):
                raise ValueError("inconsistent state arrays")
        except (KeyError, TypeError, ValueError):
            return cls()
        return model
