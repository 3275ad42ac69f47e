"""`BlasxContext` — the persistent handle layer of the two-layer BLAS API.

The paper's central claim is that a locality-aware runtime with a
two-level tile cache (ALRU L1 per device + MESI-X L2 across peers)
makes communication cost trivial.  That only holds if the caches
*survive* between calls: a context owns one long-lived
:class:`~repro_torch.core.runtime.BlasxRuntime` and keeps its tile
caches warm across routines, so chained workloads stop re-paying H2D
traffic on every call.

Key objects
-----------
``BlasxContext``
    cuBLAS-handle-style lifetime object.  All six L3 routines are
    methods (``ctx.gemm`` ... ``ctx.trsm``); each returns a
    :class:`MatrixHandle` that can be fed straight into the next call
    without re-tiling.  Per-call ledger snapshots live in
    ``ctx.calls``; cumulative counters in ``ctx.stats()``.
``MatrixHandle``
    A host matrix bound to a context under a globally unique
    ``matrix_id``.  Tile keys derive from that id, so a handle's tiles
    hit the warm caches on every subsequent call.
``default_context()``
    Module-cached context used by the legacy ``repro_torch.core.blas3``
    wrappers.

The context computes on the card (``device="cuda"``) unless the caller
asks for the CPU with ``device="cpu"``; without a card the default
raises instead of running on the host.  Asynchronous submission,
batched GEMM, the CBLAS layer, request scopes / tenant quotas and the
autotuner are not ported yet.

Example
-------
>>> from repro_torch.api import BlasxContext
>>> with BlasxContext() as ctx:
...     W = ctx.tile(weights)          # host matrix, tiles cached on the card
...     for x in batches:
...         y = ctx.gemm(ctx.tile(x), W)   # W's tiles stay cached
...         use(y.array())
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core import task as taskmod
from ..core.dtypes import promote_dtypes, validate_backend_dtype
from ..core.runtime import BlasxRuntime, RuntimeConfig
from ..core.tiling import TiledMatrix, host_tensor

DEFAULT_TILE = 256

# ctx.calls keeps at most this many CallRecords (cumulative counters in
# stats() are unaffected) so a long-lived default context stays bounded
MAX_CALL_RECORDS = 512

ArrayLike = Union[np.ndarray, torch.Tensor, "MatrixHandle"]

# one global id stream so handles never alias across contexts either
_MATRIX_IDS = itertools.count()


def _as2d(x, name: str, dtype: Optional[torch.dtype] = None
          ) -> torch.Tensor:
    """A 2-D host tensor of ``x`` — numpy arrays are shared, not copied,
    unless ``dtype`` asks for a cast."""
    t = host_tensor(x)
    if t.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t


class MatrixHandle:
    """A tiled matrix registered with one :class:`BlasxContext`.

    The handle pins a globally unique ``matrix_id`` so that tile keys
    are stable across calls — the warm-cache contract.  The data stays
    in host memory (the paper's out-of-core model); device copies of
    individual tiles live in the runtime's ALRU caches.

    Mutating ``handle.array()`` in place after tiles have been cached
    makes device copies stale; call :meth:`invalidate` afterwards.
    """

    def __init__(self, ctx: "BlasxContext", tiled: TiledMatrix):
        self._ctx = ctx
        self._tiled = tiled

    @property
    def matrix_id(self) -> str:
        return self._tiled.matrix_id

    @property
    def shape(self):
        return tuple(self._tiled.data.shape)

    @property
    def tile(self) -> int:
        return self._tiled.grid.tile

    @property
    def dtype(self) -> torch.dtype:
        """Storage precision of the handle (and of its cached tiles)."""
        return self._tiled.data.dtype

    @property
    def tiled(self) -> TiledMatrix:
        return self._tiled

    def array(self):
        """The host data, no copy: a numpy view for float64/float32/
        float16, the CPU tensor itself for bfloat16 (numpy has none)."""
        data = self._tiled.data
        return data if data.dtype == torch.bfloat16 else data.numpy()

    def invalidate(self) -> int:
        """Drop every cached device copy of this matrix's tiles.

        Needed after in-place mutation of :meth:`array`.  Returns the
        number of tiles dropped."""
        return self._ctx._invalidate_matrix(self.matrix_id)

    def __repr__(self) -> str:
        return (f"MatrixHandle({self.matrix_id}, shape={self.shape}, "
                f"tile={self.tile})")


@dataclasses.dataclass(frozen=True)
class CallRecord:
    """Ledger snapshot of one routine executed by a context (deltas
    against the runtime's cumulative counters)."""

    index: int
    routine: str
    h2d_bytes: int
    d2h_bytes: int
    d2d_bytes: int
    tasks: int
    steals: int
    l1_hits: int
    l1_misses: int
    makespan: float        # modeled seconds this call added (sim mode)
    # pod tier: ICI ring-scatter hops + neighbor-tier serves (0 on
    # plain accelerator contexts)
    ici_bytes: int = 0

    @property
    def input_bytes(self) -> int:
        return self.h2d_bytes + self.d2d_bytes + self.ici_bytes


class CallLog:
    """The per-call ledger snapshots of one context, its closed flag,
    and the reentrant lock that serializes the context's calls.

    Every routine of a context runs with :attr:`lock` held: the runtime
    under it is not re-entrant, and the side='R' reductions re-enter
    the routines.  The records and the flag are touched only by the
    methods below, under the same lock.

    It is a class of its own rather than fields of ``BlasxContext``
    because the reference's lock-order lint (``repro.analysis``) keys
    lock-owning classes by their bare name: a port class named
    ``BlasxContext`` that declared a lock would take the place of the
    reference's context in that graph.
    """

    _GUARDED_BY = {"lock": ("_closed", "_calls", "_n_calls")}

    def __init__(self):
        self.lock = threading.RLock()
        self._closed = False
        self._calls: List[CallRecord] = []   # last MAX_CALL_RECORDS only
        self._n_calls = 0                    # lifetime count

    @property
    def closed(self) -> bool:
        with self.lock:
            return self._closed

    def close(self) -> bool:
        """Mark closed; True only for the call that closed it."""
        with self.lock:
            if self._closed:
                return False
            self._closed = True
            return True

    def check_open(self) -> None:
        with self.lock:
            closed = self._closed
        if closed:
            raise RuntimeError("BlasxContext is closed")

    @property
    def n_calls(self) -> int:
        with self.lock:
            return self._n_calls

    def records(self) -> List[CallRecord]:
        with self.lock:
            return list(self._calls)

    def last(self) -> Optional[CallRecord]:
        with self.lock:
            return self._calls[-1] if self._calls else None

    def record(self, make_record) -> CallRecord:
        """Number and keep the record ``make_record(index)`` builds."""
        with self.lock:
            rec = make_record(self._n_calls)
            self._n_calls += 1
            self._calls.append(rec)
            if len(self._calls) > MAX_CALL_RECORDS:
                del self._calls[0]
            return rec

    def forget_all(self) -> None:
        with self.lock:
            self._calls = []
            self._n_calls = 0


class BlasxContext:
    """Persistent two-level-cache BLAS handle (cuBLAS-handle analogue).

    Parameters
    ----------
    config:
        Any :class:`~repro_torch.core.runtime.RuntimeConfig`; defaults
        to a single simulated device.  Ignored when ``runtime`` is given.
    runtime:
        Adopt an existing :class:`BlasxRuntime` instead of building one.
    tile:
        Default tile size for :meth:`tile` and auto-tiled array inputs.
    backend:
        Execution backend shorthand (``"torch" | "cuda"``); overrides
        ``config.backend``.  With ``runtime=`` it must match the
        adopted runtime's backend.
    device:
        Where tiles are computed (``"cuda"`` by default, ``"cpu"`` on
        request); overrides ``config.device``, and with ``runtime=`` it
        must match.
    dtype:
        Default storage/compute precision.  When set, :meth:`tile` and
        the routines cast raw-array operands to it and outputs are
        produced in it.  ``None`` (default) promotes from the inputs.
        Each routine also takes a per-call ``dtype=``.
    device_class, mesh:
        The pod tier: ``device_class="mesh_shard"`` (implied by a bare
        ``mesh=N``) makes each scheduler device a ring of ``mesh``
        shards (see ``RuntimeConfig``).

    The context is a context manager; :meth:`close` drops all cached
    tiles.  All methods are thread-safe: calls serialize on the
    reentrant lock of the context's :class:`CallLog` (the runtime is
    not re-entrant).  ``runtime``/``cfg``/``tile_size``/``dtype`` are
    fixed after ``__init__``.
    """

    def __init__(self, config: Optional[RuntimeConfig] = None, *,
                 runtime: Optional[BlasxRuntime] = None,
                 tile: int = DEFAULT_TILE,
                 backend: Optional[str] = None,
                 device: Optional[str] = None,
                 dtype=None,
                 device_class: Optional[str] = None,
                 mesh: Optional[int] = None):
        # an adopted runtime (runtime=) belongs to the caller
        self._owns_runtime = runtime is None
        if runtime is not None:
            for name, want, have in (("backend", backend,
                                      runtime.cfg.backend),
                                     ("device", device, runtime.cfg.device)):
                if want is not None and want != have:
                    raise ValueError(
                        f"{name}={want!r} conflicts with adopted "
                        f"runtime's {name} {have!r}")
            if device_class is not None or mesh is not None:
                raise ValueError(
                    "device_class=/mesh= cannot be combined with an "
                    "adopted runtime= (set them on its RuntimeConfig)")
        else:
            config = config or RuntimeConfig(n_devices=1, mode="sim")
            changes: Dict[str, object] = {}
            if backend is not None:
                changes["backend"] = backend
            if device is not None:
                changes["device"] = device
            # mesh= sets the per-device ring width and implies the
            # mesh_shard class (a ring of 1 is just an accelerator)
            if device_class is None and mesh is not None and \
                    config.device_class == "accelerator":
                device_class = "mesh_shard"
            if device_class is not None:
                changes["device_class"] = device_class
            if mesh is not None:
                changes["mesh_devices"] = mesh
            if changes:
                config = dataclasses.replace(config, **changes)
            runtime = BlasxRuntime(config)
        self.runtime = runtime
        self.cfg = self.runtime.cfg
        self.tile_size = tile
        # fail fast: an unsupported dtype is a config error, not
        # something to surface on the first routine call
        self.dtype = (validate_backend_dtype(dtype, self.cfg.backend)
                      if dtype is not None else None)
        self._log = CallLog()
        self._lock = self._log.lock

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "BlasxContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drop all cached tiles.  Idempotent; further routine calls
        raise ``RuntimeError``.  An adopted runtime belongs to the
        caller and keeps its caches and ledgers."""
        with self._lock:
            if self._log.close() and self._owns_runtime:
                self.runtime.reset()

    @property
    def closed(self) -> bool:
        return self._log.closed

    def _check_open(self) -> None:
        self._log.check_open()

    @property
    def calls(self) -> List[CallRecord]:
        """The last ``MAX_CALL_RECORDS`` call records (a copy)."""
        return self._log.records()

    @property
    def n_calls(self) -> int:
        """Routine calls since construction or the last reset."""
        return self._log.n_calls

    def _resolve_dtype(self, dtype) -> Optional[torch.dtype]:
        """Per-call ``dtype=`` beats the context default; ``None`` when
        neither is set (promote from the inputs)."""
        if dtype is None:
            return self.dtype
        return validate_backend_dtype(dtype, self.cfg.backend)

    # ------------------------------------------------------------- handles
    def tile(self, data, tile: Optional[int] = None,
             dtype=None) -> MatrixHandle:
        """Register a host matrix and return its handle.

        A numpy array (or CPU tensor) of the handle's dtype is shared,
        not copied: ``handle.array()`` is the caller's memory.  Tiles
        fetched during later calls stay in the runtime's L1/L2 caches
        keyed by this handle's unique ``matrix_id`` — reusing the
        handle is what turns repeat traffic into cache hits.

        ``dtype`` (or the context default) casts the data on
        registration.  Re-registering an existing handle only enforces
        a dtype that was passed explicitly."""
        self._check_open()
        if isinstance(tile, str):
            raise ValueError("tile must be an int; the autotuner "
                             "(tile='auto') is not ported yet")
        dt = self._resolve_dtype(dtype)
        if isinstance(data, MatrixHandle):
            return self._adopt(data, dt if dtype is not None else None,
                               "matrix")
        a = _as2d(data, "matrix", dt)
        self._check_exec_dtype(a.dtype)
        mid = f"M{next(_MATRIX_IDS)}"
        return MatrixHandle(self, TiledMatrix(mid, a, tile or self.tile_size))

    def _adopt(self, h: MatrixHandle, dtype=None,
               name: str = "matrix") -> MatrixHandle:
        if h._ctx is not self:
            raise ValueError(
                f"handle {h.matrix_id} belongs to a different context; "
                "tile caches do not transfer between contexts")
        if dtype is not None and h.dtype != dtype:
            # a handle owns its storage; recasting behind the caller's
            # back would silently decouple it from its cached tiles
            raise ValueError(
                f"{name}: handle {h.matrix_id} is {h.dtype}, call "
                f"requested dtype {dtype}; re-tile the data at the "
                "desired precision")
        return h

    def _coerce(self, x: ArrayLike, name: str, tile: Optional[int],
                ephemeral: List["MatrixHandle"],
                dtype: Optional[torch.dtype] = None,
                strict: bool = False) -> MatrixHandle:
        """Handle passthrough; raw arrays are tiled fresh (cold) and
        recorded in ``ephemeral`` — their matrix id is unique to this
        one call, so any tiles they leave in the caches could never be
        hit again and are dropped right after the run.  ``dtype`` casts
        raw arrays; handles must already match it only when ``strict``
        (an explicit per-call ``dtype=``)."""
        if isinstance(x, MatrixHandle):
            if tile is not None and x.tile != tile:
                raise ValueError(
                    f"{name}: handle tile {x.tile} != requested tile {tile}")
            return self._adopt(x, dtype if strict else None, name)
        h = self.tile(_as2d(x, name, dtype), tile or self.tile_size,
                      dtype=dtype)
        ephemeral.append(h)
        return h

    def _fresh_out(self, rows: int, cols: int, tile: int, dtype,
                   seed: Optional[torch.Tensor] = None) -> MatrixHandle:
        """New output matrix under a fresh id (seeded from C or zeros)."""
        if seed is not None:
            data = seed.to(dtype=dtype, copy=True)
        else:
            data = torch.zeros((rows, cols), dtype=dtype)
        mid = f"M{next(_MATRIX_IDS)}"
        return MatrixHandle(self, TiledMatrix(mid, data, tile))

    def _invalidate_matrix(self, matrix_id: str) -> int:
        with self._lock:
            n = 0
            for dev in self.runtime.devices:
                for key in dev.alru.keys():
                    if key.matrix_id == matrix_id:
                        self.runtime.directory.on_evict(key, dev.id)
                        dev.alru.invalidate(key)
                        dev.store.pop(key, None)
                        n += 1
            return n

    # ------------------------------------------------------------ plumbing
    def _run(self, routine: str, tasks, mats: Dict[str, TiledMatrix],
             out_id: str,
             ephemeral: Optional[List[MatrixHandle]] = None) -> CallRecord:
        """Execute one taskized routine and append a ledger snapshot;
        the caller holds ``self._lock``."""
        rt = self.runtime
        before_comm = rt.total_comm_bytes()
        before = [(d.ledger.tasks, d.ledger.steals, d.alru.hits,
                   d.alru.misses) for d in rt.devices]
        t0 = rt.makespan()
        rt.run(tasks, mats, out_id)
        after_comm = rt.total_comm_bytes()
        d_tasks = sum(d.ledger.tasks for d in rt.devices) - \
            sum(b[0] for b in before)
        d_steals = sum(d.ledger.steals for d in rt.devices) - \
            sum(b[1] for b in before)
        d_hits = sum(d.alru.hits for d in rt.devices) - \
            sum(b[2] for b in before)
        d_miss = sum(d.alru.misses for d in rt.devices) - \
            sum(b[3] for b in before)
        for h in ephemeral or ():
            self._invalidate_matrix(h.matrix_id)
        return self._log.record(lambda index: CallRecord(
            index=index, routine=routine,
            h2d_bytes=after_comm["h2d"] - before_comm["h2d"],
            d2h_bytes=after_comm["d2h"] - before_comm["d2h"],
            d2d_bytes=after_comm["d2d"] - before_comm["d2d"],
            ici_bytes=after_comm["ici"] - before_comm["ici"],
            tasks=d_tasks, steals=d_steals,
            l1_hits=d_hits, l1_misses=d_miss,
            makespan=rt.makespan() - t0,
        ))

    @property
    def last_call(self) -> Optional[CallRecord]:
        return self._log.last()

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        """Cumulative session counters: total comm bytes, per-device
        ledgers, call count, modeled makespan."""
        rt = self.runtime
        return {
            "calls": self._log.n_calls,
            "backend": rt.cfg.backend,
            "device": rt.cfg.device,
            "comm_bytes": rt.total_comm_bytes(),
            "makespan": rt.makespan(),
            "launch": rt.launch_stats(),
            "devices": rt.stats(),
        }

    def trace(self, path: Optional[str] = None) -> dict:
        """Chrome-trace JSON of every sim batch this context scheduled
        (one track group per simulated device, one track per stream and
        link lane).  The trace accumulates across calls; :meth:`reset`
        starts a fresh one.  With ``path`` the JSON is also written to
        disk.  Outside the sim event engine (``mode="threads"`` /
        ``time_model="lump"``) the trace is valid but has no spans."""
        self._check_open()
        with self._lock:
            tr = self.runtime.trace()
        if path is not None:
            with open(path, "w") as f:
                json.dump(tr, f)
        return tr

    def reset_stats(self) -> None:
        """Zero every ledger/counter *without* dropping cached tiles."""
        with self._lock:
            self.runtime.reset_stats()
            self._log.forget_all()

    def reset(self) -> None:
        """Drop all cached tiles AND zero all counters (cold restart)."""
        with self._lock:
            self.runtime.reset()
            self._log.forget_all()

    # ======================================================== L3 routines
    def gemm(self, A: ArrayLike, B: ArrayLike, C: Optional[ArrayLike] = None,
             *, alpha: float = 1.0, beta: float = 0.0,
             transa: str = "N", transb: str = "N",
             tile: Optional[int] = None, dtype=None) -> MatrixHandle:
        """C = alpha * op(A) @ op(B) + beta * C   (Eq. 1a)."""
        self._check_open()
        transa, transb = transa.upper()[0], transb.upper()[0]
        dt = self._resolve_dtype(dtype)
        strict = dtype is not None
        with self._lock:
            eph: List[MatrixHandle] = []
            Ah = self._coerce(A, "A", tile, eph, dt, strict)
            Bh = self._coerce(B, "B", tile, eph, dt, strict)
            self._check_tiles(Ah, Bh)
            m = Ah.shape[0] if transa == "N" else Ah.shape[1]
            k = Ah.shape[1] if transa == "N" else Ah.shape[0]
            kb = Bh.shape[0] if transb == "N" else Bh.shape[1]
            n = Bh.shape[1] if transb == "N" else Bh.shape[0]
            if k != kb:
                raise ValueError(f"inner dims mismatch: {k} vs {kb}")
            out_dt = dt if dt is not None else promote_dtypes(Ah.dtype,
                                                              Bh.dtype)
            out = self._prep_c(C, (m, n), Ah.tile, out_dt, beta,
                               force=dt is not None)
            tasks = taskmod.taskize_gemm(Ah.tiled.grid, Bh.tiled.grid,
                                         out.tiled.grid, transa, transb,
                                         alpha, beta)
            mats = {h.matrix_id: h.tiled for h in (Ah, Bh, out)}
            self._run("gemm", tasks, mats, out.matrix_id, eph)
            return out

    def syrk(self, A: ArrayLike, C: Optional[ArrayLike] = None, *,
             alpha: float = 1.0, beta: float = 0.0, uplo: str = "U",
             trans: str = "N", tile: Optional[int] = None,
             dtype=None) -> MatrixHandle:
        """C = alpha * op(A) @ op(A)^T + beta * C, uplo triangle (Eq. 1b)."""
        self._check_open()
        trans = trans.upper()[0]
        dt = self._resolve_dtype(dtype)
        strict = dtype is not None
        with self._lock:
            eph: List[MatrixHandle] = []
            Ah = self._coerce(A, "A", tile, eph, dt, strict)
            n = Ah.shape[0] if trans == "N" else Ah.shape[1]
            out_dt = dt if dt is not None else Ah.dtype
            out = self._prep_c(C, (n, n), Ah.tile, out_dt, beta,
                               force=dt is not None)
            tasks = taskmod.taskize_syrk(Ah.tiled.grid, out.tiled.grid,
                                         uplo, trans, alpha, beta)
            mats = {h.matrix_id: h.tiled for h in (Ah, out)}
            self._run("syrk", tasks, mats, out.matrix_id, eph)
            return out

    def syr2k(self, A: ArrayLike, B: ArrayLike,
              C: Optional[ArrayLike] = None, *, alpha: float = 1.0,
              beta: float = 0.0, uplo: str = "U", trans: str = "N",
              tile: Optional[int] = None, dtype=None) -> MatrixHandle:
        """C = alpha*(op(A)op(B)^T + op(B)op(A)^T) + beta*C (Eq. 1e)."""
        self._check_open()
        trans = trans.upper()[0]
        dt = self._resolve_dtype(dtype)
        strict = dtype is not None
        with self._lock:
            eph: List[MatrixHandle] = []
            Ah = self._coerce(A, "A", tile, eph, dt, strict)
            Bh = self._coerce(B, "B", tile, eph, dt, strict)
            self._check_tiles(Ah, Bh)
            n = Ah.shape[0] if trans == "N" else Ah.shape[1]
            out_dt = dt if dt is not None else promote_dtypes(Ah.dtype,
                                                              Bh.dtype)
            out = self._prep_c(C, (n, n), Ah.tile, out_dt, beta,
                               force=dt is not None)
            tasks = taskmod.taskize_syr2k(Ah.tiled.grid, Bh.tiled.grid,
                                          out.tiled.grid, uplo, trans,
                                          alpha, beta)
            mats = {h.matrix_id: h.tiled for h in (Ah, Bh, out)}
            self._run("syr2k", tasks, mats, out.matrix_id, eph)
            return out

    def symm(self, A: ArrayLike, B: ArrayLike,
             C: Optional[ArrayLike] = None, *, alpha: float = 1.0,
             beta: float = 0.0, side: str = "L", uplo: str = "U",
             tile: Optional[int] = None, dtype=None) -> MatrixHandle:
        """C = alpha * sym(A) @ B + beta * C (side='L'; Eq. 1f).

        ``side='R'`` reduces to the left-side tile algorithm via the
        §III-C transpose identity on transposed host copies, so cache
        reuse applies within — not across — the call."""
        self._check_open()
        side = side.upper()[0]
        if side == "R":
            self._check_side_r_handles(dtype, A=A, B=B)
            # C = alpha*B*A + beta*C  ==  (alpha*A*B^T + beta*C^T)^T
            Bt = _host_of(B).T.contiguous()
            Ct = None if C is None else \
                _as2d(_host_of(C), "C").T.contiguous()
            out = self.symm(_host_of(A), Bt, Ct, alpha=alpha, beta=beta,
                            side="L", uplo=uplo, tile=tile, dtype=dtype)
            return self._transposed_result(out)
        dt = self._resolve_dtype(dtype)
        strict = dtype is not None
        with self._lock:
            eph: List[MatrixHandle] = []
            Ah = self._coerce(A, "A", tile, eph, dt, strict)
            Bh = self._coerce(B, "B", tile, eph, dt, strict)
            self._check_tiles(Ah, Bh)
            m, n = Bh.shape
            if Ah.shape != (m, m):
                raise ValueError(f"A must be ({m},{m}), got {Ah.shape}")
            out_dt = dt if dt is not None else promote_dtypes(Ah.dtype,
                                                              Bh.dtype)
            out = self._prep_c(C, (m, n), Ah.tile, out_dt, beta,
                               force=dt is not None)
            tasks = taskmod.taskize_symm(Ah.tiled.grid, Bh.tiled.grid,
                                         out.tiled.grid, uplo, alpha, beta)
            mats = {h.matrix_id: h.tiled for h in (Ah, Bh, out)}
            self._run("symm", tasks, mats, out.matrix_id, eph)
            return out

    def trmm(self, A: ArrayLike, B: ArrayLike, *, alpha: float = 1.0,
             side: str = "L", uplo: str = "U", transa: str = "N",
             diag: str = "N", tile: Optional[int] = None,
             dtype=None) -> MatrixHandle:
        """B := alpha * op(tri(A)) @ B (side='L'; Eq. 1d), returned as a
        new handle (functional, B is not overwritten)."""
        self._check_open()
        side = side.upper()[0]
        if side == "R":
            self._check_side_r_handles(dtype, A=A, B=B)
            # B*op(A) == (op(A)^T B^T)^T — §III-C at matrix granularity
            flip = "T" if transa.upper()[0] == "N" else "N"
            out = self.trmm(_host_of(A), _host_of(B).T.contiguous(),
                            alpha=alpha, side="L", uplo=uplo, transa=flip,
                            diag=diag, tile=tile, dtype=dtype)
            return self._transposed_result(out)
        dt = self._resolve_dtype(dtype)
        strict = dtype is not None
        with self._lock:
            eph: List[MatrixHandle] = []
            Ah = self._coerce(A, "A", tile, eph, dt, strict)
            Bh = self._coerce(B, "B", tile, eph, dt, strict)
            self._check_tiles(Ah, Bh)
            m, n = Bh.shape
            if Ah.shape != (m, m):
                raise ValueError(f"A must be ({m},{m}), got {Ah.shape}")
            # TRMM's result keeps B's dtype (unless an explicit dtype=
            # pinned the call's precision)
            out_dt = dt if dt is not None else Bh.dtype
            out = self._fresh_out(m, n, Ah.tile, out_dt)
            # B's tiles are the taskization's Cin inputs: a reused handle
            # serves them straight from the warm cache.
            tasks = taskmod.taskize_trmm(Ah.tiled.grid, Bh.tiled.grid,
                                         out.tiled.grid, uplo, transa,
                                         diag, alpha)
            mats = {h.matrix_id: h.tiled for h in (Ah, Bh, out)}
            self._run("trmm", tasks, mats, out.matrix_id, eph)
            return out

    def trsm(self, A: ArrayLike, B: ArrayLike, *, alpha: float = 1.0,
             side: str = "L", uplo: str = "U", transa: str = "N",
             diag: str = "N", tile: Optional[int] = None,
             dtype=None) -> MatrixHandle:
        """Solve op(tri(A)) @ X = alpha * B (side='L'; Eq. 1c); returns X."""
        self._check_open()
        side = side.upper()[0]
        if side == "R":
            self._check_side_r_handles(dtype, A=A, B=B)
            # X*op(A) = alpha*B  ==  op(A)^T X^T = alpha B^T
            flip = "T" if transa.upper()[0] == "N" else "N"
            out = self.trsm(_host_of(A), _host_of(B).T.contiguous(),
                            alpha=alpha, side="L", uplo=uplo, transa=flip,
                            diag=diag, tile=tile, dtype=dtype)
            return self._transposed_result(out)
        dt = self._resolve_dtype(dtype)
        strict = dtype is not None
        with self._lock:
            eph: List[MatrixHandle] = []
            Ah = self._coerce(A, "A", tile, eph, dt, strict)
            Bh = self._coerce(B, "B", tile, eph, dt, strict)
            self._check_tiles(Ah, Bh)
            m, n = Bh.shape
            if Ah.shape != (m, m):
                raise ValueError(f"A must be ({m},{m}), got {Ah.shape}")
            out_dt = dt if dt is not None else promote_dtypes(Ah.dtype,
                                                              Bh.dtype)
            out = self._fresh_out(m, n, Ah.tile, out_dt)
            tasks = taskmod.taskize_trsm(Ah.tiled.grid, Bh.tiled.grid,
                                         out.tiled.grid, uplo, transa,
                                         diag, alpha)
            mats = {h.matrix_id: h.tiled for h in (Ah, Bh, out)}
            self._run("trsm", tasks, mats, out.matrix_id, eph)
            return out

    # ------------------------------------------------------------- helpers
    def _check_side_r_handles(self, dtype, **operands) -> None:
        """side='R' reductions degrade handles to raw transposed
        copies; enforce the same ownership and dtype-mismatch rules
        the side='L' coercion path applies."""
        dt = self._resolve_dtype(dtype) if dtype is not None else None
        for name, x in operands.items():
            if isinstance(x, MatrixHandle):
                self._adopt(x, dt, name)

    def _check_exec_dtype(self, *dts) -> None:
        """Every storage dtype must be one the backend executes."""
        for dt in dts:
            validate_backend_dtype(dt, self.cfg.backend)

    @staticmethod
    def _check_tiles(*handles: "MatrixHandle") -> None:
        tiles = {h.tile for h in handles}
        if len(tiles) > 1:
            names = ", ".join(f"{h.matrix_id}={h.tile}" for h in handles)
            raise ValueError(f"tile mismatch: {names}")

    def _transposed_result(self, out: MatrixHandle) -> MatrixHandle:
        """§III-C side='R' epilogue: re-tile the transposed result and
        drop the intermediate handle's cached tiles."""
        arr = out.tiled.data.T.contiguous()
        mid = f"M{next(_MATRIX_IDS)}"
        res = MatrixHandle(self, TiledMatrix(mid, arr, out.tile))
        out.invalidate()
        return res

    def _prep_c(self, C: Optional[ArrayLike], shape, tile: int, dtype,
                beta: float, force: bool = False) -> MatrixHandle:
        if C is None:
            if beta != 0.0:
                raise ValueError("beta != 0 requires C")
            return self._fresh_out(shape[0], shape[1], tile, dtype)
        c = _as2d(_host_of(C), "C")
        if tuple(c.shape) != tuple(shape):
            raise ValueError(f"C shape {tuple(c.shape)} != {tuple(shape)}")
        if force:
            # explicit dtype= call: the requested precision wins
            return self._fresh_out(shape[0], shape[1], tile, dtype, seed=c)
        # the output keeps C's dtype (each written tile is cast to it)
        self._check_exec_dtype(c.dtype)
        return self._fresh_out(shape[0], shape[1], tile, c.dtype, seed=c)


def _host_of(x: ArrayLike) -> torch.Tensor:
    """The host tensor behind an operand (a handle's data, or the
    array itself, shared)."""
    return x.tiled.data if isinstance(x, MatrixHandle) else host_tensor(x)


# ---------------------------------------------------------- default context
_default_ctx: Optional[BlasxContext] = None
_default_lock = threading.Lock()

# per-backend default contexts: legacy callers opting into an execution
# backend per call share one warm-cache context per backend
_backend_ctxs: Dict[str, BlasxContext] = {}


def default_context() -> BlasxContext:
    """The module-cached context backing the legacy ``blas3`` functions
    (created on first use, on the card, and kept warm)."""
    global _default_ctx
    with _default_lock:
        if _default_ctx is None or _default_ctx.closed:
            _default_ctx = BlasxContext(
                RuntimeConfig(n_devices=1, mode="sim"))
        return _default_ctx


def backend_context(backend: str) -> BlasxContext:
    """The module-cached warm context for one execution backend — the
    ``backend=`` analogue of :func:`default_context`.  When the
    requested backend is the default context's, the *same* context is
    shared, so both spellings warm one tile cache."""
    global _default_ctx
    with _default_lock:
        d = _default_ctx
        if d is not None and not d.closed and d.cfg.backend == backend:
            return d
        ctx = _backend_ctxs.get(backend)
        if ctx is None or ctx.closed:
            ctx = BlasxContext(RuntimeConfig(n_devices=1, mode="sim",
                                             backend=backend))
            if backend == RuntimeConfig.backend and (d is None or d.closed):
                # this IS the default config; claim the default slot so a
                # later default_context() shares the same warm caches
                _default_ctx = ctx
            else:
                _backend_ctxs[backend] = ctx
        return ctx


def set_default_context(ctx: Optional[BlasxContext]
                        ) -> Optional[BlasxContext]:
    """Swap the process-wide default context; returns the previous one
    (not closed — the caller decides its fate)."""
    global _default_ctx
    with _default_lock:
        prev, _default_ctx = _default_ctx, ctx
        return prev


__all__ = ["BlasxContext", "MatrixHandle", "CallRecord", "CallLog",
           "default_context",
           "backend_context", "set_default_context"]
