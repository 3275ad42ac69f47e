"""Work-centric (Stream-K) decomposition of the port against the
reference.

Twins of ``test_workcentric.py``.  The planner units run the port's
planner beside the reference's and require the same partitions,
trigger counts and task graphs.  Where the reference holds outputs
against its numpy backend, the twin holds the port's numpy backend
(``device="cpu"``) against the reference's **bitwise**, and the sim
ledgers (h2d/d2d/ici bytes, launches, makespan, partial and fix-up
counts) **exactly**; owner and work-centric runs of the port must be
bitwise equal on every routine x precision x time model, in threads
mode too.  The reference's jax-backend case maps to the port's torch
backend.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core import task as ref_task
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro.core.tiling import TileGrid as RefGrid
from repro.core.tiling import degree_of_parallelism as ref_dop
from repro.core.tiling import split_ranges as ref_split_ranges
from repro.core.tiling import workcentric_parts as ref_wc_parts
from repro_torch.core import blas3
from repro_torch.core import task as taskmod
from repro_torch.core.runtime import (BlasxRuntime, RuntimeConfig,
                                      config_from_reference)
from repro_torch.core.task import KIND_FIXUP, KIND_OWNER, KIND_PARTIAL
from repro_torch.core.taskqueue import ReadyQueue, ReservationStation
from repro_torch.core.tiling import (TileGrid, degree_of_parallelism,
                                     split_ranges, workcentric_parts)

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """One BLAS thread for numpy while this module runs (the reason is
    in ``test_torch_precision.py``)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit is an economy, not a requirement
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _ref_cfg(**kw):
    kw.setdefault("n_devices", 3)
    kw.setdefault("mode", "sim")
    kw.setdefault("cache_bytes", 32 << 20)
    return RefConfig(**kw)


def _pair(**kw):
    """(reference runtime, port runtime) over one modeled machine, both
    on the numpy backend (the port's on the host)."""
    rc = _ref_cfg(**kw)
    return RefRuntime(rc), BlasxRuntime(
        config_from_reference(dataclasses.asdict(rc), device="cpu"))


def _ledgers(rt):
    """What the schedule determines: per-device stats, comm bytes,
    launch accounting and the makespan."""
    return {"stats": rt.stats(), "comm": rt.total_comm_bytes(),
            "launch": rt.launch_stats(), "makespan": rt.makespan()}


def _task_shape(t):
    return (t.task_id, t.kind, t.parent, t.i, t.j, t.beta, t.k_range,
            tuple(t.deps), len(t.steps), t.flops)


# ------------------------------------------------------- planner units
@pytest.mark.parametrize("n_steps,n_parts", [
    (3, 2), (7, 3), (8, 8), (5, 1), (12, 5)])
def test_split_ranges_is_an_exact_partition(n_steps, n_parts):
    ranges = split_ranges(n_steps, n_parts)
    assert ranges == ref_split_ranges(n_steps, n_parts)
    assert len(ranges) == min(n_parts, n_steps)
    covered = [k for start, stop in ranges for k in range(start, stop)]
    assert covered == list(range(n_steps))        # contiguous, in order
    sizes = [stop - start for start, stop in ranges]
    assert max(sizes) - min(sizes) <= 1           # balanced


def test_split_ranges_rejects_nonpositive_parts():
    with pytest.raises(ValueError):
        split_ranges(4, 0)
    with pytest.raises(ValueError):
        ref_split_ranges(4, 0)


def test_workcentric_parts_triggers():
    cases = [((32, 6, 16, False), 6), ((32, 15, 16, False), 3),
             ((2, 1, 16, False), 2), ((32, 100, 16, True), 2),
             ((32, 100, 16, False), 0), ((1, 2, 16, True), 0)]
    for (steps, owners, cap, ragged), want in cases:
        got = workcentric_parts(steps, owners, cap, ragged=ragged)
        assert got == want == ref_wc_parts(steps, owners, cap, ragged=ragged)


def _gemm_tasks(n, tile, k=None, mod=taskmod, grid=TileGrid):
    k = n if k is None else k
    ga = grid("A", n, k, tile)
    gb = grid("B", k, n, tile)
    gc = grid("C", n, n, tile)
    grids = {"A": ga, "B": gb, "C": gc}
    return mod.taskize_gemm(ga, gb, gc, "N", "N", 1.0, 0.5), grids


def _planned_pair(n, tile, capacity):
    tasks, grids = _gemm_tasks(n, tile)
    rtasks, rgrids = _gemm_tasks(n, tile, mod=ref_task, grid=RefGrid)
    planned = taskmod.plan_work_centric(tasks, grids, capacity=capacity)
    ref = ref_task.plan_work_centric(rtasks, rgrids, capacity=capacity)
    assert [_task_shape(t) for t in planned] == [_task_shape(t) for t in ref]
    return tasks, grids, planned


def test_plan_small_problem_splits_every_task():
    tasks, grids, planned = _planned_pair(256, 128, 8)
    owners = [t for t in planned if t.kind == KIND_OWNER]
    partials = [t for t in planned if t.kind == KIND_PARTIAL]
    fixups = [t for t in planned if t.kind == KIND_FIXUP]
    assert not owners                             # 4 < 8: all tasks split
    assert len(fixups) == len(tasks)
    assert len(partials) == 2 * len(tasks)
    for f in fixups:
        orig = next(t for t in tasks if t.task_id == f.task_id)
        sibs = [p for p in partials if p.parent == f.task_id]
        assert f.steps == orig.steps and f.beta == orig.beta
        assert set(f.deps) >= {p.task_id for p in sibs}
        assert all(p.beta == 0.0 for p in sibs)
        ranges = sorted(p.k_range for p in sibs)
        assert ranges[0][0] == 0 and ranges[-1][1] == len(orig.steps)
        assert sum(p.flops for p in sibs) == orig.flops
        h, w = grids["C"].tile_shape(f.i, f.j)
        assert f.flops == len(sibs) * h * w


def test_plan_large_problem_splits_only_ragged_tiles():
    tasks, grids, planned = _planned_pair(576, 128, 8)
    split_ids = {t.task_id for t in planned if t.kind == KIND_FIXUP}
    gc = grids["C"]
    for t in tasks:
        ragged = gc.tile_shape(t.i, t.j) != (128, 128)
        assert (t.task_id in split_ids) == ragged
    interior = [t for t in planned if t.kind == KIND_OWNER]
    assert all(gc.tile_shape(t.i, t.j) == (128, 128) for t in interior)


def test_plan_narrows_partial_deps_to_their_k_range():
    """TRSM's intra-column chain: the producer of C_kj is only a dep of
    the partial whose k-range actually reads that tile."""
    n, tile = 512, 128

    def plan(mod, grid):
        ga, gb, gc = (grid("A", n, n, tile), grid("B", n, n, tile),
                      grid("C", n, n, tile))
        tasks = mod.taskize_trsm(ga, gb, gc, "U", "N", "N", 1.0)
        return tasks, mod.plan_work_centric(
            tasks, {"A": ga, "B": gb, "C": gc}, capacity=64)

    tasks, planned = plan(taskmod, TileGrid)
    _, ref_planned = plan(ref_task, RefGrid)
    assert [_task_shape(t) for t in planned] == \
        [_task_shape(t) for t in ref_planned]
    dep_full = {t.task_id: t for t in tasks}
    narrowed = 0
    for p in (t for t in planned if t.kind == KIND_PARTIAL):
        owner = dep_full[p.parent]
        assert set(p.deps) <= set(owner.deps)
        read = {s.a.key for s in p.steps} | {s.b.key for s in p.steps}
        for d in p.deps:
            assert dep_full[d].out in read
        narrowed += len(owner.deps) - len(p.deps)
    assert narrowed > 0


def test_degree_of_parallelism_counts_partial_tasks():
    cases = [((512, 512, 128), {}, 16),
             ((256, 256, 128), dict(k=512, work_centric=True, capacity=8),
              20),
             ((256, 256, 128), dict(k=128, work_centric=True, capacity=8),
              4)]
    for args, kw, want in cases:
        assert degree_of_parallelism(*args, **kw) == want == \
            ref_dop(*args, **kw)


# ------------------------------------------ shape-bucket aliasing bugfix
def test_shape_bucket_no_longer_aliases_4100_into_8192():
    from repro.tuning.autotuner import shape_bucket as ref_bucket
    from repro_torch.tuning.autotuner import shape_bucket

    bucket = shape_bucket(4100, 4100, 4100)
    assert bucket == (5793, 5793, 5793) == ref_bucket(4100, 4100, 4100)
    inflation = (bucket[0] * bucket[1] * bucket[2]) / 4100 ** 3
    assert inflation <= 4.0
    assert shape_bucket(*bucket) == bucket
    assert shape_bucket(1000, 900, 1020) == (1024, 1024, 1024)
    assert shape_bucket(300, 1, 64) == (362, 64, 64)


# ------------------------------------------------------- bitwise parity
def _operands(n=320):
    rng = np.random.default_rng(42)  # identical operands per config
    return (rng.standard_normal((n, n)), rng.standard_normal((n, n)),
            rng.standard_normal((n, n)))


def _call(mod, routine, dtype, runtime, tile=128):
    A, B, C = _operands()
    n = A.shape[0]
    kw = dict(tile=tile, runtime=runtime, dtype=dtype)
    if routine == "gemm":
        return mod.gemm(A, B, C, beta=0.5, **kw)
    if routine == "symm":
        return mod.symm(A, B, **kw)
    if routine == "syrk":
        return mod.syrk(A, C, beta=0.5, uplo="L", **kw)
    if routine == "syr2k":
        return mod.syr2k(A, B, **kw)
    if routine == "trmm":
        return mod.trmm(A, B, uplo="L", **kw)
    if routine == "trsm":
        return mod.trsm(A + n * np.eye(n), B, **kw)
    raise AssertionError(routine)


def _run_pair(routine, dtype, **kw):
    """Run one routine through the reference and the port (numpy
    backend both); returns the port's output after holding it bitwise to
    the reference's, ledgers equal."""
    ref_rt, rt = _pair(**kw)
    want = _call(ref_blas3, routine, dtype, ref_rt)
    got = _call(blas3, routine, dtype, rt)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want), np.abs(got - want).max()
    if kw.get("mode", "sim") == "sim":
        assert _ledgers(rt) == _ledgers(ref_rt)
    return got


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize(
    "routine", ["gemm", "symm", "syrk", "syr2k", "trmm", "trsm"])
def test_workcentric_bitwise_parity(routine, dtype):
    """The Stream-K schedule only moves modeled clocks: the fix-up
    re-dispatches the full original k-loop through the identical
    backend path, so the port's outputs are bitwise identical to owner
    mode — and to the reference's — under both time models."""
    owner = _run_pair(routine, dtype, time_model="lump", work_centric=False)
    wc_lump = _run_pair(routine, dtype, time_model="lump", work_centric=True)
    wc_events = _run_pair(routine, dtype, time_model="events",
                          work_centric=True)
    assert owner.dtype == wc_lump.dtype == wc_events.dtype
    assert np.array_equal(owner, wc_lump)
    assert np.array_equal(owner, wc_events)


def test_workcentric_threads_mode_bitwise_parity():
    """Threads mode really schedules the partial/fix-up graph across the
    port's worker threads; any schedule must reproduce the sim-mode
    owner result (the reference's too) bit for bit."""
    owner = _run_pair("gemm", np.float64, time_model="lump",
                      work_centric=False)
    for _ in range(3):   # racy schedules differ run to run; results can't
        wc = _run_pair("gemm", np.float64, time_model="lump",
                       work_centric=True, mode="threads")
        assert np.array_equal(owner, wc)


def test_workcentric_torch_backend_parity():
    """The reference's jax-backend case on the port's torch backend:
    owner and work-centric runs bitwise equal, both true f64 (1e-10 of
    the reference's numpy result)."""
    def run(wc):
        rt = BlasxRuntime(RuntimeConfig(
            n_devices=3, mode="sim", cache_bytes=32 << 20, backend="torch",
            device="cpu", time_model="lump", work_centric=wc))
        return _call(blas3, "gemm", np.float64, rt)

    owner, wc = run(False), run(True)
    assert np.array_equal(owner, wc)
    ref_rt, _ = _pair(time_model="lump")
    want = _call(ref_blas3, "gemm", np.float64, ref_rt)
    np.testing.assert_allclose(owner, want, rtol=1e-10, atol=1e-10)


# --------------------------------------------------- ledger attribution
def test_ledger_attributes_partial_and_fixup_work():
    n, tile = 320, 128    # 3x3 owners with ragged edges, 3 k-steps
    A = np.random.default_rng(17).standard_normal((n, n))
    ref_rt, rt = _pair(n_devices=2, work_centric=True)
    out = blas3.gemm(A, A, tile=tile, runtime=rt)
    want = ref_blas3.gemm(A, A, tile=tile, runtime=ref_rt)
    assert np.array_equal(out, want)
    np.testing.assert_allclose(out, A @ A, rtol=1e-10, atol=1e-10)
    assert _ledgers(rt) == _ledgers(ref_rt)
    partials = sum(d.ledger.partial_tasks for d in rt.devices)
    fixups = sum(d.ledger.fixup_tasks for d in rt.devices)
    tasks = sum(d.ledger.tasks for d in rt.devices)
    assert fixups == 5 and partials == 10
    assert tasks == 4 + partials + fixups
    led = rt.devices[0].ledger
    assert led.partial_flops >= 0 and led.fixup_flops >= 0
    st = rt.stats()["device0"]
    for key in ("partial_tasks", "fixup_tasks",
                "partial_flops", "fixup_flops"):
        assert key in st


# ------------------------------------------------- trace kind + ordering
def test_trace_tags_partials_and_orders_fixups_after_siblings():
    from repro_torch.core.events import trace_spans, validate_trace

    n, tile = 320, 128
    A = np.random.default_rng(17).standard_normal((n, n))
    ref_rt, rt = _pair(n_devices=2, work_centric=True, time_model="events")
    blas3.gemm(A, A, tile=tile, runtime=rt)
    ref_blas3.gemm(A, A, tile=tile, runtime=ref_rt)
    tr = rt.trace()
    validate_trace(tr)
    compute = [s for s in trace_spans(tr) if s["cat"] == "compute"]
    partials = [s for s in compute if s["kind"] == "partial"]
    fixups = {s["task_id"]: s for s in compute if s["kind"] == "fixup"}
    assert partials and fixups
    for p in partials:
        f = fixups[p["parent"]]
        assert f["start"] >= p["end"] - 1e-12
    from repro.core.events import trace_spans as ref_spans

    def roles(spans):
        return [(s["kind"], s["task_id"], s.get("parent"), s["start"],
                 s["end"]) for s in spans if s["cat"] == "compute"]

    assert roles(trace_spans(tr)) == roles(ref_spans(ref_rt.trace()))


# ------------------------------------------------ stealing under partials
def test_ready_queue_never_releases_fixup_before_siblings():
    tasks, grids = _gemm_tasks(256, 128)
    planned = taskmod.plan_work_centric(tasks, grids, capacity=8)
    partials = [t for t in planned if t.kind == KIND_PARTIAL]
    q = ReadyQueue(planned)
    drained = [q.try_dequeue() for _ in range(len(partials))]
    assert all(t is not None and t.kind == KIND_PARTIAL for t in drained)
    assert q.try_dequeue() is None
    *rest, last = drained
    for t in rest:
        q.complete(t)
    early = []
    while (t := q.try_dequeue()) is not None:
        early.append(t)
    assert all(t.kind == KIND_FIXUP for t in early)
    assert last.parent not in {t.task_id for t in early}
    assert q.pending_count() == 1
    q.complete(last)
    released = q.try_dequeue()
    assert released is not None and released.kind == KIND_FIXUP
    assert released.task_id == last.parent
    assert any(t.parent == last.parent for t in rest)


def test_rs_steal_hands_over_a_runnable_fixup():
    tasks, grids = _gemm_tasks(256, 128)
    planned = taskmod.plan_work_centric(tasks, grids, capacity=8)
    fixup = next(t for t in planned if t.kind == KIND_FIXUP)
    victim = ReservationStation(device_id=0, n_slots=4)
    victim.put(fixup, priority=0.0)
    stolen = victim.steal()
    assert stolen is fixup and len(victim) == 0


def test_stealing_with_work_centric_completes_every_fixup():
    """A 16x speed skew forces the fast device to steal from the slow
    one's station mid-run; numerics stay bitwise the reference's and
    every split tile still gets exactly one fix-up executed."""
    n, tile = 320, 128
    r = np.random.default_rng(5)
    A, B = r.standard_normal((n, n)), r.standard_normal((n, n))
    ref_rt, rt = _pair(n_devices=2, work_centric=True,
                       speeds=[4.0, 0.25], nominal_speeds=[4.0, 0.25])
    out = blas3.gemm(A, B, tile=tile, runtime=rt)
    want = ref_blas3.gemm(A, B, tile=tile, runtime=ref_rt)
    assert np.array_equal(out, want)
    np.testing.assert_allclose(out, A @ B, rtol=1e-10, atol=1e-10)
    assert _ledgers(rt) == _ledgers(ref_rt)
    assert sum(d.ledger.steals for d in rt.devices) > 0
    assert sum(d.ledger.fixup_tasks for d in rt.devices) == 5
