"""The BLASX locality-aware dynamic scheduling runtime (paper §IV, Alg. 1).

Two execution modes share every data structure (ALRU, MESI-X directory,
heap, reservation stations, global ready queue, communication ledger):

  * ``threads`` — faithful to the paper: one host thread per device,
    demand-driven work sharing off the global queue, work stealing from
    peer reservation stations, asynchronous batch execution with
    reader-count release at the stream-sync point.
  * ``sim``     — a deterministic virtual-clock engine over the same
    components.  Devices consume tasks in earliest-free-time order
    (exactly the paper's "demand driven" behaviour, but reproducible),
    and per-batch time is modeled from device speed and link bandwidth.
    All Table III/V and Fig. 7/8/10 analogues run in this mode.

Scheduling policies (the paper's baselines are implemented, §II):

  * ``blasx``       — dynamic demand + stealing + Eq. 3 locality priority,
                      L1+L2 tile caches (the paper's contribution);
  * ``parsec``      — dynamic demand, L1 cache only, FIFO priority
                      (h-PaRSEC-like: no inter-GPU cache);
  * ``cublasxt``    — static round-robin tile assignment, NO tile cache
                      (on-demand transfer per k-step), 2 streams;
  * ``static``      — MAGMA-like static contiguous split proportional to
                      device speed, L1 cache, no stealing;
  * ``supermatrix`` — dynamic demand, no cache, fork-join (no
                      communication/computation overlap).

PyTorch port
------------
The scheduler, the cache hierarchy, the event engine and the modeled
constants are the reference's, unchanged, so the same configuration
gives the same ledger.  What changes is where the bytes live: matrices
stay in host memory as CPU tensors; every tile a simulated device
fetches is copied to ``RuntimeConfig.device`` (the H100, by default)
and its tile store holds device tensors.  All simulated devices share
that one card; an L2 "P2P" serve hands the peer's tensor over, as the
reference hands over its array.  Step groups run on the device through
the backend, the epilogue runs there too, and ``write_tile`` copies the
finished output tile back to the host.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..backends import create_backend
from ..backends.numpy_backend import DEVICE_ERROR as NUMPY_DEVICE_ERROR
from ..backends.base import StepGroupKey
from .alru import Alru
from .coherence import MesixDirectory
from .dtypes import dtype_name, promote_dtypes
from .events import EventEngine, TimedTask, TimedXfer
from .heap import BlasxHeap
from .spans import span
from . import task as taskmod
from .task import KIND_FIXUP, KIND_PARTIAL, Ledger, Task, TileRef
from .taskqueue import ReadyQueue, ReservationStation
from .tile_kernels import materialize
from .tiling import TiledMatrix, TileKey

# paper Table IV: measured DMA throughputs on Everest
H2D_BW = 6.54e9   # bytes/s, bidirectional host <-> device
D2D_BW = 7.80e9   # bytes/s, GPU <-> GPU peer
ICI_BW = 4.50e10  # bytes/s, per-link inter-chip interconnect (pod tier)
DEFAULT_PEAK_FLOPS = 1.43e12  # K40c double-precision-ish peak (paper §V-A)

# sentinel payload used by metadata-only runs (execute=False)
_METADATA_ONLY = torch.empty(0)


def _scalable(x: torch.Tensor) -> torch.Tensor:
    """An integer tile as float64 before alpha/beta scale it: numpy
    scales an integer array by a Python float in float64, torch would
    in float32 (inexact past 2**24)."""
    return x if x.is_floating_point() else x.to(torch.float64)


def _tile_label(key) -> str:
    """Human-readable tile name for trace spans."""
    return f"{key.matrix_id}[{key.i},{key.j}]"


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """What one scheduler "device" *is* (pod tier).

    The paper's runtime schedules over a flat set of accelerators; at
    pod scale one scheduler device may instead be a whole ICI ring of
    mesh shards whose compute step is a ring-scheduled SPMD step
    (the reference's ``repro.core.distributed``).  The class abstracts
    exactly the two places the difference matters to the runtime: how fast one
    "device" computes, and what a fresh host panel costs to scatter
    across it.  Everything else — ALRU, MESI-X, heap, queues — is
    class-agnostic.
    """

    name: str
    # compute step is a ring-scheduled pod step over `mesh_devices`
    # shards (core.distributed) rather than a single accelerator kernel
    ring: bool

    def peak_flops(self, peak: float, mesh_devices: int) -> float:
        """Effective peak of one scheduler device: a ``mesh_shard``
        device is a whole ring, so its peak is the per-shard peak
        times the ring size."""
        return peak * (mesh_devices if self.ring else 1)

    def hop_bytes(self, nbytes: int, mesh_devices: int) -> int:
        """ICI bytes one fresh host panel costs to scatter across the
        ring: a ring all-gather forwards ``(d-1)/d`` of the panel per
        shard (``ring_allgather_matmul``'s ppermute traffic).  Zero for
        plain accelerators — their fills never touch ICI."""
        if not self.ring or mesh_devices <= 1:
            return 0
        return nbytes * (mesh_devices - 1) // mesh_devices


DEVICE_CLASSES: Dict[str, DeviceClass] = {
    "accelerator": DeviceClass("accelerator", ring=False),
    "mesh_shard": DeviceClass("mesh_shard", ring=True),
}


@dataclasses.dataclass
class RuntimeConfig:
    n_devices: int = 2
    cache_bytes: int = 256 << 20          # per-device L1 tile-cache capacity
    n_streams: int = 4                    # paper: 4 concurrent tasks/streams
    rs_slots: Optional[int] = None        # RS capacity (default 2*n_streams)
    policy: str = "blasx"
    # execution backend: torch | cuda | numpy (see repro_torch.backends;
    # numpy is a host engine and needs device="cpu").  ``kernel`` is the
    # reference's legacy spelling; ``backend`` wins when both are given,
    # neither given is "cuda", and the two are equal after __post_init__.
    kernel: Optional[str] = None
    backend: Optional[str] = None
    # where tiles are computed: the card unless the caller asks for the
    # CPU (the tests do).  A runtime on "cuda" without a card raises.
    device: str = "cuda"
    speeds: Optional[Sequence[float]] = None   # realtime device speeds
    # what a static scheduler *believes* the speeds are (MAGMA/PaRSEC
    # assume constant nominal speed; realtime saturation differs — §IV-C)
    nominal_speeds: Optional[Sequence[float]] = None
    p2p_groups: Optional[Sequence[Sequence[int]]] = None  # default: one group
    mode: str = "sim"                     # sim | threads
    # sim-mode timing engine: "events" schedules every tile fetch,
    # compute span and write-back on per-stream/per-link timelines
    # (repro_torch.core.events); "lump" is the seed max(compute, comm) model,
    # kept for the bitwise parity suite and A/B timing studies.
    # Numerics are identical under both (only modeled clocks differ).
    time_model: str = "events"
    # force communication/computation overlap on (True) or off (False)
    # regardless of policy; None derives it from the policy (only the
    # fork-join supermatrix baseline runs unoverlapped).  The overlap
    # bench lane uses this to measure the same policy both ways.
    overlap_comm: Optional[bool] = None
    # record the event timeline for trace() export (sim+events only).
    # None resolves to ``execute``: real runs record by default (the
    # ctx.trace() contract), metadata-scale shadow sweeps — the runs
    # big enough for span memory to matter — opt in explicitly.
    record_trace: Optional[bool] = None
    peak_flops: float = DEFAULT_PEAK_FLOPS
    h2d_bw: float = H2D_BW
    d2d_bw: float = D2D_BW
    # all devices share the host PCI-E root complex: concurrent H2D
    # transfers contend (the paper's "cuBLAS-XT overloads the PCI-E").
    # P2P transfers ride dedicated switch lanes and do not contend.
    shared_host_link: bool = True
    # execute=False: metadata-only run — full scheduling/cache/ledger
    # behaviour, no numerics.  Lets benchmarks run at the paper's true
    # scale (N=16384..40K, T=1024) on this 1-core host.
    execute: bool = True
    # work-centric (Stream-K) scheduling: split the k-loop of ragged /
    # underfilled output tiles (and of every tile of a small problem)
    # into partial tasks joined by a deterministic fix-up reduction —
    # see repro_torch.core.task.plan_work_centric.  Numerics are bitwise
    # identical to owner mode; only the schedule (and modeled clocks)
    # change.  Searched by the runtime autotuner alongside tile size,
    # n_streams and policy.
    work_centric: bool = False
    # --- pod tier (3-level cache: host DRAM -> HBM -> ICI neighbor) ---
    # what one scheduler "device" is: "accelerator" (the paper's flat
    # model, bit-and-timing-identical to before this knob existed) or
    # "mesh_shard" (one device = a whole ICI ring of `mesh_devices`
    # shards whose compute step is a ring-scheduled pod step from
    # the reference's repro.core.distributed).  See DEVICE_CLASSES.
    device_class: str = "accelerator"
    mesh_devices: int = 1                 # ring size per mesh_shard device
    ici_bw: float = ICI_BW                # bytes/s per ICI link
    # panel staging (repro_torch.core.task.plan_panel_staged): split
    # beyond-HBM tasks into panel-sized partials + fix-up so host
    # panels stream through the tile cache instead of bypassing it.
    # None derives from the device class (mesh shards stage, plain
    # accelerators don't); the pod bench forces False for its
    # direct-host baseline.  Bitwise-identical numerics either way.
    stage_panels: Optional[bool] = None
    seed: int = 0

    def __post_init__(self):
        if self.policy not in ("blasx", "parsec", "cublasxt", "static",
                               "supermatrix"):
            raise ValueError(f"unknown policy {self.policy}")
        if self.backend is None:
            self.backend = self.kernel or "cuda"
        if self.backend not in ("torch", "cuda", "numpy"):
            raise ValueError(f"unknown backend {self.backend}")
        self.kernel = self.backend
        if str(self.device).split(":")[0] not in ("cpu", "cuda"):
            raise ValueError(f"unknown device {self.device!r}")
        if self.backend == "numpy" and \
                str(self.device).split(":")[0] != "cpu":
            raise ValueError(f"{NUMPY_DEVICE_ERROR}; got "
                             f"device={self.device!r}")
        if self.time_model not in ("events", "lump"):
            raise ValueError(f"unknown time_model {self.time_model}")
        if self.record_trace is None:
            self.record_trace = bool(self.execute)
        if self.speeds is None:
            self.speeds = [1.0] * self.n_devices
        if len(self.speeds) != self.n_devices:
            raise ValueError("speeds length != n_devices")
        if self.nominal_speeds is None:
            self.nominal_speeds = list(self.speeds)
        if self.rs_slots is None:
            self.rs_slots = 2 * self.n_streams
        if self.p2p_groups is None:
            self.p2p_groups = [list(range(self.n_devices))]
        if self.device_class not in DEVICE_CLASSES:
            raise ValueError(
                f"unknown device_class {self.device_class!r} "
                f"(expected one of {sorted(DEVICE_CLASSES)})")
        if self.ici_bw <= 0:
            raise ValueError("ici_bw must be positive")
        if self.dclass.ring:
            if self.mesh_devices < 2:
                raise ValueError(
                    "mesh_shard devices are whole ICI rings: "
                    "mesh_devices must be >= 2")
        elif self.mesh_devices != 1:
            raise ValueError(
                "mesh_devices != 1 requires device_class='mesh_shard'")

    @property
    def dclass(self) -> DeviceClass:
        return DEVICE_CLASSES[self.device_class]

    @property
    def stage_panels_on(self) -> bool:
        """Whether run() applies the panel-staging planner; explicit
        ``stage_panels`` wins, else the device class decides."""
        if self.stage_panels is not None:
            return self.stage_panels
        return self.dclass.ring

    @property
    def device_peak_flops(self) -> float:
        """Effective peak of ONE scheduler device (a mesh_shard device
        is a whole ring — see DeviceClass.peak_flops)."""
        return self.dclass.peak_flops(self.peak_flops, self.mesh_devices)

    @property
    def use_cache(self) -> bool:
        return self.policy in ("blasx", "parsec", "static")

    @property
    def use_l2(self) -> bool:
        return self.policy == "blasx"

    @property
    def use_priority(self) -> bool:
        return self.policy == "blasx"

    @property
    def use_stealing(self) -> bool:
        return self.policy in ("blasx", "parsec", "supermatrix")

    @property
    def static_assignment(self) -> Optional[str]:
        return {"cublasxt": "roundrobin", "static": "speed"}.get(self.policy)

    @property
    def overlap(self) -> bool:
        if self.overlap_comm is not None:
            return self.overlap_comm
        return self.policy != "supermatrix"

    @property
    def h2d_bw_eff(self) -> float:
        """Per-device host bandwidth under contention."""
        return self.h2d_bw / (self.n_devices if self.shared_host_link
                              else 1)

    @property
    def effective_streams(self) -> int:
        return 2 if self.policy == "cublasxt" else self.n_streams

    def topology(self) -> Dict[str, object]:
        """The fields that describe the *machine* this config models —
        device count/speeds, P2P grouping, link bandwidths, cache and
        compute capacity — excluding the knobs the runtime autotuner
        searches (tile size, ``n_streams``, ``policy``) and anything
        that cannot change modeled time (seed, trace recording).  The
        tuning layer fingerprints this dict: two configs with equal
        topologies share one tuning-cache namespace."""
        return {
            "n_devices": self.n_devices,
            "speeds": list(self.speeds),
            "nominal_speeds": list(self.nominal_speeds),
            "p2p_groups": [list(g) for g in self.p2p_groups],
            "cache_bytes": self.cache_bytes,
            "peak_flops": self.peak_flops,
            "h2d_bw": self.h2d_bw,
            "d2d_bw": self.d2d_bw,
            "shared_host_link": self.shared_host_link,
            "device_class": self.device_class,
            "mesh_devices": self.mesh_devices,
            "ici_bw": self.ici_bw,
        }


class ServeMeter:
    """P2P seconds one device has spent serving peers' L2 hits (the
    ledger's ``d2d_served_s``).  In threads mode the *peers'* workers
    charge it, concurrently with each other, so the meter owns the lock
    that orders those charges; :meth:`BlasxRuntime.run` copies the
    total into the device's ledger once no worker is running.  The
    total is cumulative like the ledger field it mirrors (same
    summation order, so the two packages agree to the bit)."""

    _GUARDED_BY = {"_lock": ("_seconds",)}

    def __init__(self):
        self._lock = threading.Lock()
        self._seconds = 0.0

    def charge(self, secs: float) -> None:
        with self._lock:
            self._seconds += secs

    def total(self) -> float:
        with self._lock:
            return self._seconds

    def reset(self) -> None:
        with self._lock:
            self._seconds = 0.0


class DeviceSim:
    """One simulated accelerator: private heap + ALRU (L1 tile cache) +
    tile store (device tensors) + ledger."""

    def __init__(self, device_id: int, cfg: RuntimeConfig,
                 directory: MesixDirectory):
        self.id = device_id
        self.cfg = cfg
        self.speed = float(cfg.speeds[device_id])
        self.heap = BlasxHeap(cfg.cache_bytes)
        self.alru = Alru(device_id, self.heap)
        self.store: Dict[TileKey, torch.Tensor] = {}
        self.ledger = Ledger()
        self.served = ServeMeter()
        self.rs = ReservationStation(device_id, cfg.rs_slots)
        self.clock = 0.0  # sim-mode virtual time
        self._directory = directory

    def forget(self, keys: Sequence[TileKey]) -> None:
        """Sync the directory and the tile store with blocks the ALRU
        evicted (it reports them instead of calling back under its
        lock; see ``repro_torch.core.alru``)."""
        for key in keys:
            self._directory.on_evict(key, self.id)
            self.store.pop(key, None)


@dataclasses.dataclass
class _TaskExec:
    """In-flight execution record of one task within a device batch:
    materialized inputs gathered in phase 1, per-step products filled
    in by the backend dispatch in phase 2."""

    task: Task
    a_tiles: List[torch.Tensor]
    b_tiles: List[torch.Tensor]
    products: List[Optional[torch.Tensor]]  # per-step path (mixed signatures)
    acc: Optional[torch.Tensor] = None    # task-contraction path result
    diag: Optional[torch.Tensor] = None   # TRSM diagonal tile
    rhs: Optional[torch.Tensor] = None    # TRSM right-hand side
    cin: Optional[torch.Tensor] = None    # beta != 0 C input
    # timed transfers collected while gathering/finalizing — the event
    # engine's raw material (kind, bytes, modeled seconds per movement)
    xfers: List[TimedXfer] = dataclasses.field(default_factory=list)
    wb: Optional[TimedXfer] = None      # finalize-phase write-back


class BlasxRuntime:
    """Executes taskized L3 BLAS calls over simulated devices (Alg. 1).

    A runtime is a *session*: ``run`` may be called any number of
    times and the tile caches (ALRU L1 + MESI-X L2), device clocks and
    communication ledgers persist across calls — tiles cached by one
    routine are served warm to the next, provided callers keep tile
    keys stable (unique matrix ids per matrix; see
    ``repro_torch.api.BlasxContext``).  Ledgers accumulate; callers wanting
    per-call numbers snapshot around ``run`` (``CallRecord`` in the
    context layer does this).  ``reset()`` returns the session to a
    cold state, ``reset_stats()`` zeroes counters but keeps caches
    warm.
    """

    def __init__(self, cfg: RuntimeConfig):
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"RuntimeConfig(device={cfg.device!r}) needs a CUDA card and "
                "none is available; pass device='cpu' to run on the host")
        self.cfg = cfg
        self.directory = MesixDirectory(cfg.n_devices, cfg.p2p_groups)
        self.devices = [DeviceSim(d, cfg, self.directory)
                        for d in range(cfg.n_devices)]
        self.backend = create_backend(cfg.backend)
        self.runs = 0
        # the discrete-event timing engine only exists where virtual
        # clocks do: sim mode with time_model="events".  Threads mode
        # measures real wall time; "lump" keeps the seed max() model.
        self._engine: Optional[EventEngine] = (
            EventEngine(cfg) if cfg.mode == "sim"
            and cfg.time_model == "events" else None)
        # serving front-end state (repro_torch.serve): which tenant the
        # in-flight run belongs to (tags ALRU blocks for the quota
        # machinery) and its priority-class boost (additive Eq. 3
        # term).  Quotas live here too so reset() can reapply them to
        # the rebuilt devices.
        self._tenant: Optional[str] = None
        self._boost: float = 0.0
        self._tenant_quotas: Dict[str, int] = {}

    # ------------------------------------------------------------- public
    def run(self, tasks: Sequence[Task], matrices: Dict[str, TiledMatrix],
            out_id: str, *, tenant: Optional[str] = None,
            priority_boost: float = 0.0) -> None:
        """Execute all tasks; the output matrix (``matrices[out_id]``) is
        updated in place tile by tile.

        ``tenant`` attributes every tile this run pulls into the ALRU
        caches to that owner (the serving layer's per-tenant quota
        machinery keys off the tag); ``priority_boost`` is the
        request's priority-class term, added to every task's Eq. 3
        locality priority for the duration of the run (the serving
        front end maps ``interactive``/``batch`` onto it)."""
        self._tenant = tenant
        self._boost = float(priority_boost)
        self.runs += 1
        if not tasks:
            return
        with span("blasx.rt.plan"):
            if self.cfg.work_centric:
                tasks = taskmod.plan_work_centric(
                    tasks, {mid: m.grid for mid, m in matrices.items()},
                    self.cfg.n_devices * self.cfg.effective_streams)
            if self.cfg.stage_panels_on:
                # pod tier: beyond-HBM tasks become panel-sized partials
                # + fix-up so host panels stream through the cache
                # hierarchy (runs after the work-centric planner; both
                # skip non-owner tasks, so the two compose without
                # double-splitting)
                tasks = taskmod.plan_panel_staged(tasks, matrices,
                                                  self.cfg.cache_bytes)
            self._matrices = matrices
            self._out_id = out_id
            if self.cfg.static_assignment:
                queues = self._static_split(tasks)
                self._queue = None
                self._static_queues = queues
            else:
                self._queue = ReadyQueue(tasks)
                self._static_queues = None
        self._completed: Dict[int, float] = {}
        try:
            if self.cfg.mode == "threads":
                self._run_threads(tasks)
            else:
                self._run_sim(tasks)
        finally:
            # no worker is running now: publish the serve meters
            for d in self.devices:
                d.ledger.d2d_served_s = d.served.total()

    # ----------------------------------------------------- static policies
    def _static_split(self, tasks: Sequence[Task]) -> List[ReadyQueue]:
        n = self.cfg.n_devices
        buckets: List[List[Task]] = [[] for _ in range(n)]
        if self.cfg.static_assignment == "roundrobin":
            for idx, t in enumerate(tasks):
                buckets[idx % n].append(t)
        else:  # contiguous split proportional to NOMINAL speed (MAGMA-like)
            total_speed = sum(self.cfg.nominal_speeds)
            total_fl = sum(t.flops for t in tasks) or 1
            shares = [s / total_speed for s in self.cfg.nominal_speeds]
            acc = 0.0
            dev = 0
            budget = shares[0] * total_fl
            for t in tasks:
                if acc > budget and dev < n - 1:
                    dev += 1
                    budget += shares[dev] * total_fl
                buckets[dev].append(t)
                acc += t.flops
        # NB: a static split cannot respect TRSM chains across devices;
        # ReadyQueue still enforces them (a device may stall — exactly the
        # pathology the paper ascribes to static scheduling).
        return [ReadyQueue(b) for b in buckets]

    # --------------------------------------------------------------- sim
    def _run_sim(self, tasks: Sequence[Task]) -> None:
        n_left = len(tasks)
        stall_guard = 0
        active = set(range(self.cfg.n_devices))
        while n_left > 0:
            d = min((self.devices[i] for i in active),
                    key=lambda x: (x.clock, x.id))
            batch = self._fill_and_take(d)
            if not batch:
                # will this device ever get work again?
                if len(d.rs) == 0 and not self.cfg.use_stealing:
                    src = (self._static_queues[d.id]
                           if self._static_queues is not None else self._queue)
                    if src.drained() and not src.has_ready():
                        active.discard(d.id)
                        if not active:
                            raise RuntimeError("all devices retired with "
                                               f"{n_left} tasks left")
                        continue
                stall_guard += 1
                if stall_guard > 8 * self.cfg.n_devices + 64:
                    raise RuntimeError(
                        "scheduler livelock: pending dependencies never "
                        "resolved (task DAG cycle?)")
                # nudge the starved device's clock past the next busy
                # one; the skipped time is *idle* (a dependency stall),
                # ledger-charged so busy + idle always sums to the
                # device clock instead of silently inflating makespan
                busy = [self.devices[i].clock for i in active
                        if self.devices[i] is not d]
                before = d.clock
                d.clock = max(d.clock, min(busy) if busy else d.clock) + 1e-9
                d.ledger.idle_time += d.clock - before
                continue
            stall_guard = 0
            ready_at = max((self._completed.get(dep, 0.0)
                            for t in batch for dep in t.deps), default=0.0)
            start = max(d.clock, ready_at)
            if start > d.clock:  # waited on a producer: idle, not busy
                d.ledger.idle_time += start - d.clock
            span, finishes = self._execute_batch(d, batch, start)
            d.clock = start + span
            d.ledger.busy_time += span
            for t, fin in zip(batch, finishes):
                self._completed[t.task_id] = fin
                self._complete(t)
                n_left -= 1

    def _pick_device(self) -> DeviceSim:
        return min(self.devices, key=lambda d: (d.clock, d.id))

    # ------------------------------------------------------------ threads
    def _run_threads(self, tasks: Sequence[Task]) -> None:
        n_left = [len(tasks)]
        cv = threading.Condition()   # signaled on completion and on error
        errors: List[BaseException] = []
        # per-device batch taken out of the RS but not yet completed —
        # a crashing worker leaves its entry for the post-join requeue
        inflight: Dict[int, List[Task]] = {}

        def done() -> bool:  # call with cv held
            return n_left[0] <= 0 or bool(errors)

        # completion generation: bumped on every completed batch so a
        # worker whose empty _fill_and_take raced a peer's completion
        # retries immediately instead of sleeping out the wait timeout
        gen = [0]

        def worker(d: DeviceSim) -> None:
            try:
                while True:
                    with cv:
                        if done():
                            return
                        my_gen = gen[0]
                    batch = self._fill_and_take(d)
                    if not batch:
                        # nothing runnable (deps pending / peers hold all
                        # work): park until a peer completes a batch or
                        # crashes.  The generation check closes the
                        # lost-wakeup window between the empty take and
                        # acquiring the cv; the timeout is a safety net
                        # against a missed notify, not a poll interval.
                        with cv:
                            if done():
                                return
                            if gen[0] == my_gen:
                                cv.wait(timeout=0.05)
                        continue
                    inflight[d.id] = batch
                    t0 = time.perf_counter()
                    self._execute_batch(d, batch)
                    d.ledger.busy_time += time.perf_counter() - t0
                    with cv:
                        # pop each task as it completes so an exception
                        # mid-loop leaves only the genuinely uncompleted
                        # tail for the crash-recovery requeue (a cleared-
                        # at-the-end list would requeue completed tasks)
                        pending = inflight[d.id]
                        while pending:
                            self._complete(pending[0])
                            n_left[0] -= 1
                            pending.pop(0)
                        gen[0] += 1
                        cv.notify_all()
            except BaseException as e:  # surface worker crashes
                with cv:
                    # append order under the lock = true failure order;
                    # errors[0] below is the first real failure
                    errors.append(e)
                    cv.notify_all()

        threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                   for d in self.devices]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            # workers bailed out with work still parked in reservation
            # stations (their own refills + stolen tasks) and, for the
            # crashed worker, an in-flight batch already taken from its
            # RS.  Return all of it to the owning queue so the session's
            # task accounting shows no stranded tasks: every task is
            # either completed or dequeueable again.
            for d in self.devices:
                src = (self._static_queues[d.id]
                       if self._static_queues is not None else self._queue)
                for t in d.rs.drain():
                    src.requeue(t)
                for t in inflight.get(d.id, ()):
                    src.requeue(t)
            raise errors[0]

    # ------------------------------------------------- scheduling plumbing
    def _dequeue_for(self, d: DeviceSim) -> Optional[Task]:
        if self._static_queues is not None:
            return self._static_queues[d.id].try_dequeue()
        return self._queue.try_dequeue()

    def _complete(self, t: Task) -> None:
        if self._static_queues is not None:
            for q in self._static_queues:
                q.complete(t)  # owner decrements; others resolve dep edges
        else:
            self._queue.complete(t)

    def _fill_and_take(self, d: DeviceSim) -> List[Task]:
        # work sharing: refill RS from the global (or static) queue
        while d.rs.free_slots() > 0:
            t = self._dequeue_for(d)
            if t is None:
                break
            d.rs.put(t, self._priority(d, t))
        # work stealing: only when RS is empty and the queue gave nothing
        if len(d.rs) == 0 and self.cfg.use_stealing:
            victim = max((x for x in self.devices if x is not d),
                         key=lambda x: len(x.rs), default=None)
            if victim is not None and len(victim.rs) > 0:
                # refresh the victim station's priorities against the
                # VICTIM's current cache state (Eq. 3): put-time values
                # are stale once tiles landed in its L1/L2, and a stale
                # sort would let the thief walk off with an L1-hot task
                prio_fn = ((lambda t: self._priority(victim, t))
                           if self.cfg.use_priority else None)
                stolen = victim.rs.steal(prio_fn)
                if stolen is not None:
                    d.rs.put(stolen, self._priority(d, stolen))
                    d.ledger.steals += 1
        if len(d.rs) == 0:
            return []
        if self.cfg.use_priority:
            d.rs.set_priorities(lambda t: self._priority(d, t))
        return d.rs.take_top(self.cfg.effective_streams)

    def _priority(self, d: DeviceSim, t: Task) -> float:
        """Eq. 3: +2 per L1-resident input tile, +1 per L2 (peer) tile,
        plus the in-flight run's priority-class boost (serving front
        end: interactive requests outrank batch in every reservation
        station their tasks ever share)."""
        if not self.cfg.use_priority:
            return 0.0
        p = self._boost
        for ref in t.input_refs():
            if ref.key in d.alru:
                p += 2.0
            elif self.cfg.use_l2 and \
                    self.directory.peer_holder(ref.key, d.id) is not None:
                p += 1.0
        return p

    # ----------------------------------------------------------- execution
    def _execute_batch(self, d: DeviceSim, batch: List[Task],
                       start: float = 0.0) -> Tuple[float, List[float]]:
        """Run up to ``n_streams`` tasks as one overlapped batch; returns
        ``(modeled span, per-task finish times)`` relative to ``start``
        (sim mode; threads mode measures real wall time and ignores
        both).  Readers are released at the end — the paper's
        StreamsSynch + ReaderUpdate point.

        Execution is a three-phase pipeline:

          1. *gather*   — acquire every input tile through the two-level
             cache (all communication accounting happens here, in the
             same per-task order the sequential engine used);
          2. *dispatch* — group the batch's k-steps by
             (op, trans, fill, tile-shape, dtype) and hand each group to
             the execution backend as ONE batched call — the paper's
             stream-level concurrency, minus the per-step dispatch tax;
          3. *finalize* — per-task epilogue (alpha/beta, TRSM solve,
             triangle masks) and MESI-X write-back.

        Timing happens after the numerics: with the event engine every
        gathered transfer, per-task compute share and write-back is
        scheduled onto stream/link timelines (overlap and contention
        emerge); the "lump" model reproduces the seed
        ``max(compute, comm)``.  Both see identical tile data — the
        time model can never change results.

        Tasks in one batch are dependency-free w.r.t. each other (the
        ReadyQueue only releases a task after its deps *complete*, and
        completion happens after the batch), so hoisting all reads
        before all writes preserves the sequential semantics."""
        acquired: List[TileKey] = []
        comm_s = 0.0
        compute_each: List[float] = []
        recs: List[_TaskExec] = []
        try:
            with span("blasx.rt.gather"):
                for t in batch:
                    rec, secs = self._gather_task(d, t, acquired)
                    recs.append(rec)
                    comm_s += secs
            with span("blasx.rt.dispatch"):
                if self.cfg.execute:
                    self._dispatch_steps(d, recs)
            with span("blasx.rt.finalize"):
                for rec in recs:
                    comm_s += self._finalize_task(d, rec)
                    compute_each.append(rec.task.flops / (
                        d.speed * self.cfg.device_peak_flops))
                    d.ledger.tasks += 1
                    d.ledger.flops += rec.task.flops
                    if rec.task.kind == KIND_PARTIAL:
                        d.ledger.partial_tasks += 1
                        d.ledger.partial_flops += rec.task.flops
                    elif rec.task.kind == KIND_FIXUP:
                        d.ledger.fixup_tasks += 1
                        d.ledger.fixup_flops += rec.task.flops
        except BaseException:
            # a failing batch must not leave its acquired tiles pinned:
            # the readers would never hit the release below, permanently
            # blocking eviction/invalidation of those blocks in this
            # session (each acquired entry is one translate increment)
            for key in acquired:
                d.alru.release(key)
            raise
        # reader update (the ALRU may evict these from now on)
        for key in acquired:
            d.alru.release(key)
        compute_s = sum(compute_each)
        d.ledger.compute_time += compute_s
        d.ledger.comm_time += comm_s
        if self._engine is not None:
            return self._schedule_events(d, recs, compute_each, compute_s,
                                         comm_s, start)
        # lump-sum model (time_model="lump" and threads mode): one
        # duration for the whole batch, all tasks finish together
        if self.cfg.overlap:
            d.ledger.unoverlapped_comm += max(0.0, comm_s - compute_s)
            dur = max(compute_s, comm_s)
        else:
            d.ledger.unoverlapped_comm += comm_s
            dur = compute_s + comm_s
        return dur, [start + dur] * len(batch)

    def _schedule_events(self, d: DeviceSim, recs: List["_TaskExec"],
                         compute_each: List[float], compute_s: float,
                         comm_s: float, start: float
                         ) -> Tuple[float, List[float]]:
        """Hand the batch's timed material to the discrete-event engine
        and charge the schedule-derived ledger metrics."""
        items = []
        for rec, comp in zip(recs, compute_each):
            t = rec.task
            items.append(TimedTask(
                task_id=t.task_id,
                name=f"{t.routine} C[{t.i},{t.j}]",
                compute_s=comp, fetches=rec.xfers, writeback=rec.wb,
                routine=t.routine, steps=len(t.steps), flops=t.flops,
                kind=t.kind, parent=t.parent))
        span, finishes, busy = self._engine.schedule_batch(
            d.id, start, items, self.cfg.effective_streams,
            self.cfg.overlap)
        led = d.ledger
        led.h2d_busy_s += busy["h2d"]
        led.d2d_busy_s += busy["d2d"]
        led.d2h_busy_s += busy["d2h"]
        led.ici_busy_s += busy["ici"]
        # Fig. 8 "COMM": batch span not covered by an equal amount of
        # compute — the generalization of the lump model's
        # max(0, comm - compute) to a multi-stream schedule.  Capped at
        # the batch's own link seconds: span beyond that is contention
        # *waiting* (Fig. 8 "OTHER"), not data movement.
        led.unoverlapped_comm += min(comm_s, max(0.0, span - compute_s))
        return span, finishes

    def _xfer_secs(self, kind: str, nbytes: int) -> float:
        """Modeled seconds for one transfer.  The event engine charges
        full link bandwidth — host-link contention emerges from
        serialization on the shared lane; the lump model (and threads
        mode) keeps the seed per-device bandwidth divide."""
        if kind == "d2d":
            return nbytes / self.cfg.d2d_bw
        if kind == "ici":
            # every ICI movement charges exactly nbytes/ici_bw, so the
            # events engine's ici_busy_s == ici_bytes/ici_bw holds by
            # construction (the pod bench gates this invariant)
            return nbytes / self.cfg.ici_bw
        if self._engine is not None:
            return nbytes / self.cfg.h2d_bw
        return nbytes / self.cfg.h2d_bw_eff

    def _gather_task(self, d: DeviceSim, t: Task,
                     acquired: List[TileKey]) -> Tuple["_TaskExec", float]:
        """Phase 1: pull every input tile of one task through the cache
        hierarchy (ledger-charged) and materialize it for compute.
        Every charged movement is also recorded on ``rec.xfers`` — the
        event engine's per-fetch raw material."""
        comm_s = 0.0
        rec = _TaskExec(task=t, a_tiles=[], b_tiles=[],
                        products=[None] * len(t.steps))
        # pod tier: a mesh_shard fix-up is a streaming ring-reduce over
        # the panels its partials staged — it reads each tile once, so
        # caching them would only displace the warm panels other tasks
        # are reusing.  Stream the re-gather through the bypass path
        # (own HBM free, peer ring over ICI, host as last resort)
        # instead of the ALRU.  Accelerator-class fix-ups keep the
        # caching gather (bit-and-timing parity with PR 9).
        streaming = t.kind == KIND_FIXUP and self.cfg.dclass.ring
        for step in t.steps:
            if streaming:
                a, s1 = self._bypass_read(d, step.a, rec.xfers)
                b, s2 = self._bypass_read(d, step.b, rec.xfers)
            else:
                a, s1 = self._acquire(d, step.a, acquired, rec.xfers)
                b, s2 = self._acquire(d, step.b, acquired, rec.xfers)
            comm_s += s1 + s2
            rec.a_tiles.append(a)
            rec.b_tiles.append(b)
        if t.finalize is not None:  # TRSM
            rec.diag, s1 = self._acquire(d, t.finalize.diag_ref, acquired,
                                         rec.xfers)
            rec.rhs, s2 = self._bypass_read(d, t.finalize.rhs_ref,
                                            rec.xfers)
            comm_s += s1 + s2
        elif t.read_c is not None:
            rec.cin, s3 = self._bypass_read(d, t.read_c, rec.xfers)
            comm_s += s3
        return rec, comm_s

    def _step_key(self, t: Task, step, a: torch.Tensor, b: torch.Tensor,
                  steps: int = 1) -> StepGroupKey:
        return StepGroupKey(
            op=t.routine, transa=step.a.trans, transb=step.b.trans,
            fill_a=step.a.fill, fill_b=step.b.fill,
            m=a.shape[0], k=a.shape[1], n=b.shape[1],
            dtype=dtype_name(promote_dtypes(a.dtype, b.dtype)), steps=steps)

    def _dispatch_steps(self, d: DeviceSim, recs: List["_TaskExec"]) -> None:
        """Phase 2: one backend call per same-signature group.

        A task whose k-steps all share one signature (the common case:
        every interior tile of GEMM/SYRK/TRSM sweeps) is dispatched as
        a single *item* — its whole k-loop contracts inside the backend
        (``acc = sum_j a_j @ b_j``), so same-shape tasks in the batch
        become one work-centric batched call.  Mixed-signature tasks
        (SYMM/TRMM diagonal fills, ragged edge tiles) degrade to
        per-step items within their signature groups."""
        task_groups: Dict[StepGroupKey, List[_TaskExec]] = {}
        step_groups: Dict[StepGroupKey, List[Tuple[_TaskExec, int]]] = {}
        for rec in recs:
            t = rec.task
            if not t.steps or t.kind == KIND_PARTIAL:
                # a partial-k task only prefetches and models compute;
                # its fix-up re-dispatches the whole k-loop through
                # this very path, so skipping here keeps launch counts
                # and numerics identical to owner mode
                continue
            keys = [self._step_key(t, step, rec.a_tiles[i], rec.b_tiles[i])
                    for i, step in enumerate(t.steps)]
            if len(set(keys)) == 1:
                key = dataclasses.replace(keys[0], steps=len(t.steps))
                task_groups.setdefault(key, []).append(rec)
            else:
                for i, key in enumerate(keys):
                    step_groups.setdefault(key, []).append((rec, i))
        led = d.ledger
        for key, t_recs in task_groups.items():
            res = self.backend.run_group(
                key, [a for r in t_recs for a in r.a_tiles],
                [b for r in t_recs for b in r.b_tiles])
            n_steps = key.steps * len(t_recs)
            led.batched_groups += 1
            led.batched_steps += n_steps
            led.kernel_launches += res.launches
            led.engine_flops[res.engine] = (
                led.engine_flops.get(res.engine, 0)
                + key.flops_per_item * len(t_recs))
            for rec, acc in zip(t_recs, res.products):
                rec.acc = acc
        for key, entries in step_groups.items():
            res = self.backend.run_group(
                key, [r.a_tiles[i] for r, i in entries],
                [r.b_tiles[i] for r, i in entries])
            led.batched_groups += 1
            led.batched_steps += len(entries)
            led.kernel_launches += res.launches
            led.engine_flops[res.engine] = (
                led.engine_flops.get(res.engine, 0)
                + key.flops_per_item * len(entries))
            for (rec, idx), prod in zip(entries, res.products):
                rec.products[idx] = prod

    def _finalize_task(self, d: DeviceSim, rec: "_TaskExec") -> float:
        """Phase 3: per-task epilogue + write-back; returns comm secs."""
        t = rec.task
        if t.kind == KIND_PARTIAL:
            # the sibling fix-up performs the owner-identical numerics
            # and the ONLY write of C_ij: partials never touch the
            # coherence directory and spill no accumulator (the modeled
            # join traffic is the fix-up's re-gather of the k-range
            # tiles the partials left warm in peer L1s)
            return 0.0
        out_grid = self._matrices[self._out_id]
        comm_s = 0.0
        if self.cfg.execute:
            acc: Optional[torch.Tensor] = rec.acc
            if acc is None:
                for prod in rec.products:  # original k-step order
                    acc = prod if acc is None else acc + prod
            if acc is None:
                h, w = out_grid.grid.tile_shape(t.i, t.j)
                acc = torch.zeros((h, w), dtype=out_grid.dtype,
                                  device=self.device)
            acc = _scalable(acc)
            if t.finalize is not None:  # TRSM
                result = self.backend.solve_triangular(
                    rec.diag, t.alpha * rec.rhs - acc,
                    lower=t.finalize.lower, unit_diag=t.finalize.unit_diag)
            else:
                result = t.alpha * acc
                if rec.cin is not None:
                    result = result + t.beta * _scalable(rec.cin)
            if t.out_mask is not None:
                # diagonal SYRK/SYR2K tile: only the uplo triangle is written
                orig = out_grid.read_tile(t.i, t.j).to(self.device)
                if t.out_mask == "tri_u":
                    result = torch.triu(result) + torch.tril(orig, -1)
                else:
                    result = torch.tril(result) + torch.triu(orig, 1)
        # MESI-X ephemeral M: write back to host immediately, invalidate
        # any cached copies, transition to I (Fig. 3).
        for holder in self.directory.on_write(t.out, d.id):
            self.devices[holder].alru.invalidate(t.out)
        if self.cfg.execute:
            out_grid.write_tile(t.i, t.j, result.to(out_grid.dtype))
        wb = out_grid.nbytes(t.i, t.j)
        d.ledger.d2h_bytes += wb
        secs = self._xfer_secs("d2h", wb)
        rec.wb = TimedXfer("d2h", wb, secs, _tile_label(t.out))
        comm_s += secs
        return comm_s

    # ------------------------------------------------------ data movement
    def _acquire(self, d: DeviceSim, ref: TileRef, acquired: List[TileKey],
                 xfers: List[TimedXfer]) -> Tuple[torch.Tensor, float]:
        """Fetch a cacheable input tile through the 2-level tile cache.
        Every charged movement is appended to ``xfers`` (cache hits add
        nothing — they cost no link time).  A host fill is a real copy
        of the tile to the runtime's device."""
        key = ref.key
        mat = self._matrices[key.matrix_id]
        nbytes = mat.nbytes(key.i, key.j)
        if not self.cfg.use_cache:
            data, secs = self._bypass_read(d, ref, xfers)
            return data, secs

        block, evicted = d.alru.translate(key, nbytes, owner=self._tenant)
        # sync the directory and store outside the ALRU lock: a peer
        # that reads a stale holder in between finds a valid payload or
        # None, and None is answered below with a host fetch
        d.forget(evicted)
        if block is None:
            # every cached block pinned: degrade to an uncached read
            data, secs = self._bypass_read(d, ref, xfers)
            return data, secs
        acquired.append(key)
        secs = 0.0
        if getattr(block, "fresh", False):
            block.fresh = False
            peer = (self.directory.peer_holder(key, d.id)
                    if self.cfg.use_l2 else None)
            payload = None
            if peer is not None:
                payload = self.devices[peer].store.get(key)
            if payload is not None:  # L2 tile-cache hit: P2P fetch
                # pod tier: between mesh_shard devices the peer link IS
                # the ICI fabric — L2 serves ride it at ici_bw and are
                # ledgered as ici_bytes (d2d stays the PCIe-P2P lane of
                # plain accelerators), keeping the comm decomposition
                # exact per device class
                kind = "ici" if self.cfg.dclass.ring else "d2d"
                if kind == "ici":
                    d.ledger.ici_bytes += nbytes
                else:
                    d.ledger.d2d_bytes += nbytes
                secs = self._xfer_secs(kind, nbytes)
                xfers.append(TimedXfer(kind, nbytes, secs,
                                       _tile_label(key), src=peer))
                # egress accounting + LRU rotation on the SERVING side:
                # the peer's lane is the one being drained, and marking
                # the serve is what spreads the next hit to its
                # least-recently-used group mate.  The charge targets
                # ANOTHER device, so it goes through that device's
                # locked meter, never its ledger.
                self.devices[peer].served.charge(secs)
                self.directory.mark_served(peer)
            else:                    # miss in both levels: host fetch
                payload = (self._to_device(mat.read_tile(key.i, key.j))
                           if self.cfg.execute else _METADATA_ONLY)
                d.ledger.h2d_bytes += nbytes
                secs = self._xfer_secs("h2d", nbytes)
                xfers.append(TimedXfer("h2d", nbytes, secs,
                                       _tile_label(key)))
                secs += self._ring_hop(d, key, nbytes, xfers)
            d.store[key] = payload
            self.directory.on_fill(key, d.id)
        data = d.store.get(key)
        if data is None:  # extremely unlikely: evicted between ops
            data = self._to_device(mat.read_tile(key.i, key.j)) \
                if self.cfg.execute else _METADATA_ONLY
            d.ledger.h2d_bytes += nbytes
            s2 = self._xfer_secs("h2d", nbytes)
            xfers.append(TimedXfer("h2d", nbytes, s2, _tile_label(key)))
            s2 += self._ring_hop(d, key, nbytes, xfers)
            secs += s2
        if not self.cfg.execute:
            return data, secs
        return materialize(data, ref), secs

    def _to_device(self, tile: torch.Tensor) -> torch.Tensor:
        """A private device copy of a host tile (the H2D fill).  On the
        host it is row-major, the layout of the reference's
        ``ndarray.copy()``, so the numpy backend hands ``np.dot`` what
        the reference's does; onto the card it keeps the tile's
        layout."""
        layout = torch.contiguous_format if self.device.type == "cpu" \
            else torch.preserve_format
        return tile.to(self.device, memory_format=layout, copy=True)

    def _ring_hop(self, d: DeviceSim, key: TileKey, nbytes: int,
                  xfers: List[TimedXfer]) -> float:
        """Pod tier: a fresh host panel landing on a mesh_shard device
        must be scattered across its ICI ring (each shard forwards
        (mesh-1)/mesh of the bytes — ring_allgather_matmul's ppermute
        traffic).  Charged once per host fill; warm cache hits and
        plain accelerators pay nothing."""
        hop = self.cfg.dclass.hop_bytes(nbytes, self.cfg.mesh_devices)
        if hop <= 0:
            return 0.0
        d.ledger.ici_bytes += hop
        secs = self._xfer_secs("ici", hop)
        xfers.append(TimedXfer("ici", hop, secs, _tile_label(key)))
        return secs

    def _bypass_read(self, d: DeviceSim, ref: TileRef,
                     xfers: List[TimedXfer]) -> Tuple[torch.Tensor, float]:
        """Uncached read (C_ij inputs / no-cache policies / pinned-full
        ALRU).  On a mesh_shard device with the L2 directory live this
        is where the cache hierarchy's THIRD level pays off: if a peer
        ring holds the tile (a staging partial left the panel warm in
        its L1), serve it over ICI at ``ici_bw`` instead of re-reading
        host DRAM — the fix-up join of a beyond-HBM task re-gathers its
        whole k-loop through this path."""
        key = ref.key
        mat = self._matrices[key.matrix_id]
        nbytes = mat.nbytes(key.i, key.j)
        if self.cfg.dclass.ring and self.cfg.use_l2:
            payload = d.store.get(key)
            if payload is not None:  # already in this ring's own HBM
                if not self.cfg.execute:
                    return _METADATA_ONLY, 0.0
                return materialize(payload, ref), 0.0
            peer = self.directory.peer_holder(key, d.id)
            payload = (self.devices[peer].store.get(key)
                       if peer is not None else None)
            if payload is not None:  # neighbor-tier (ICI) hit
                d.ledger.ici_bytes += nbytes
                secs = self._xfer_secs("ici", nbytes)
                xfers.append(TimedXfer("ici", nbytes, secs,
                                       _tile_label(key), src=peer))
                self.directory.mark_served(peer)
                if not self.cfg.execute:
                    return _METADATA_ONLY, secs
                return materialize(payload, ref), secs
        d.ledger.h2d_bytes += nbytes
        secs = self._xfer_secs("h2d", nbytes)
        xfers.append(TimedXfer("h2d", nbytes, secs, _tile_label(key)))
        secs += self._ring_hop(d, key, nbytes, xfers)
        if not self.cfg.execute:
            return _METADATA_ONLY, secs
        return materialize(mat.read_tile(key.i, key.j).to(self.device),
                           ref), secs

    def set_tenant_quota(self, tenant: str, nbytes: Optional[int]) -> None:
        """Cap ``tenant``'s resident ALRU bytes on every device (None
        removes the cap).  While any quota is configured the caches
        refuse cross-tenant eviction — a flooding tenant recycles its
        own blocks instead of another tenant's warm set.  Blocks evicted
        to get under a lowered cap leave the directory and the tile
        store, so their device memory is freed."""
        if nbytes is None:
            self._tenant_quotas.pop(tenant, None)
        else:
            self._tenant_quotas[tenant] = int(nbytes)
        for d in self.devices:
            d.forget(d.alru.set_quota(tenant, nbytes))

    # ----------------------------------------------------------- sessions
    def reset(self) -> None:
        """Cold restart: drop every cached tile, rebuild the coherence
        directory, zero all ledgers and clocks.  The next ``run`` pays
        full H2D traffic again."""
        self.directory = MesixDirectory(self.cfg.n_devices,
                                        self.cfg.p2p_groups)
        self.devices = [DeviceSim(d, self.cfg, self.directory)
                        for d in range(self.cfg.n_devices)]
        self.runs = 0
        if self._engine is not None:  # fresh timelines and trace
            self._engine = EventEngine(self.cfg)
        for tenant, nbytes in self._tenant_quotas.items():
            for d in self.devices:
                d.alru.set_quota(tenant, nbytes)

    def reset_stats(self) -> None:
        """Zero ledgers and cache counters *without* evicting anything —
        session-boundary accounting for long-lived runtimes.  Device
        clocks are kept (they order the sim's virtual time); use the
        deltas of :meth:`makespan` across calls."""
        for d in self.devices:
            d.ledger = Ledger()
            d.served.reset()
            d.alru.reset_stats()
        self.directory.writebacks = 0
        self.directory.invalidations = 0

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for d in self.devices:
            led = dataclasses.asdict(d.ledger)
            led.update(l1_hits=d.alru.hits, l1_misses=d.alru.misses,
                       evictions=d.alru.evictions,
                       quota_evictions=d.alru.quota_evictions,
                       cache_used=d.heap.used, clock=d.clock,
                       overlap_efficiency=d.ledger.overlap_efficiency)
            out[f"device{d.id}"] = led
        return out

    def trace(self) -> dict:
        """Chrome-trace (chrome://tracing / Perfetto) JSON of every sim
        batch scheduled so far: one process per device, one thread per
        stream/link lane, balanced B/E spans (see
        ``repro_torch.core.events``).  The trace accumulates across ``run``
        calls of a session; ``reset()`` starts a fresh one.  Outside
        the event engine (threads mode / ``time_model="lump"``) the
        trace is valid but empty."""
        from .events import build_chrome_trace
        extra = {
            "policy": self.cfg.policy,
            "backend": self.cfg.backend,
            "time_model": self.cfg.time_model,
            "mode": self.cfg.mode,
            "makespan_s": self.makespan(),
        }
        if self._engine is None:
            return build_chrome_trace([], self.cfg.n_devices,
                                      self.cfg.effective_streams,
                                      extra=extra)
        return self._engine.chrome_trace(extra=extra)

    def launch_stats(self) -> Dict[str, object]:
        """Batched-dispatch accounting across devices: how many k-steps
        ran, how many kernel launches they cost, and which engine did
        the flops — the bench lane's ``launches saved`` source."""
        engine_flops: Dict[str, int] = {}
        for d in self.devices:
            for eng, fl in d.ledger.engine_flops.items():
                engine_flops[eng] = engine_flops.get(eng, 0) + fl
        steps = sum(d.ledger.batched_steps for d in self.devices)
        launches = sum(d.ledger.kernel_launches for d in self.devices)
        return {
            "backend": self.cfg.backend,
            "tasks": sum(d.ledger.tasks for d in self.devices),
            "steps": steps,
            "groups": sum(d.ledger.batched_groups for d in self.devices),
            "kernel_launches": launches,
            "launches_saved": steps - launches,
            "engine_flops": engine_flops,
        }

    def total_comm_bytes(self) -> Dict[str, int]:
        return {
            "h2d": sum(d.ledger.h2d_bytes for d in self.devices),
            "d2h": sum(d.ledger.d2h_bytes for d in self.devices),
            "d2d": sum(d.ledger.d2d_bytes for d in self.devices),
            "ici": sum(d.ledger.ici_bytes for d in self.devices),
        }

    def makespan(self) -> float:
        """Sim-mode modeled wall time (max device clock)."""
        return max((d.clock for d in self.devices), default=0.0)


# reference backend name -> the port's counterpart
_BACKEND_COUNTERPARTS = {"numpy": "numpy", "jax": "torch", "pallas": "cuda"}


def config_from_reference(d: Dict[str, object],
                          device: str = "cuda") -> RuntimeConfig:
    """Build the port's config from ``dataclasses.asdict`` of a
    reference ``repro.core.runtime.RuntimeConfig``: every field carries
    over unchanged (so the modeled machine, and with it the ledger, is
    the same), the backend maps ``numpy -> numpy``, ``jax -> torch`` and
    ``pallas -> cuda``, and ``device`` says where the port computes (the
    numpy backend only on ``"cpu"``)."""
    fields = dict(d)
    kernel = fields.pop("kernel", None)
    backend = fields.pop("backend", None) or kernel
    if backend not in _BACKEND_COUNTERPARTS:
        raise ValueError(
            f"reference backend {backend!r} has no counterpart in the port "
            f"(expected one of {sorted(_BACKEND_COUNTERPARTS)})")
    fields["backend"] = _BACKEND_COUNTERPARTS[backend]
    fields["device"] = device
    return RuntimeConfig(**fields)
