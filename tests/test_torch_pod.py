"""The port's pod tier against the reference's.

Twins of ``test_pod.py``: device classes, the 3-level tile cache (host
DRAM -> device memory -> ICI neighbour), panel staging for beyond-memory
GEMMs, ICI lane/ledger accounting, the knobs through context, blas3 and
CBLAS, and the tuner's topology fingerprint.  Both packages run the
numpy backend (the port's on the host), so outputs are held bitwise and
the ledgers (h2d/d2d/ici bytes, launches, makespan) exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core import task as ref_task
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro.core.tiling import TiledMatrix as RefTiled
from repro.core.tiling import TileGrid as RefGrid
from repro.core.tiling import panel_parts as ref_panel_parts
from repro_torch.core import blas3
from repro_torch.core import task as taskmod
from repro_torch.core.runtime import (DEVICE_CLASSES, BlasxRuntime,
                                      DeviceClass, RuntimeConfig,
                                      config_from_reference)
from repro_torch.core.task import KIND_FIXUP, KIND_OWNER, KIND_PARTIAL
from repro_torch.core.tiling import TiledMatrix, TileGrid, panel_parts

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


TILE = 64
TILE_BYTES = TILE * TILE * 8                     # f64 tile
# beyond-memory regime: 512x512 needs 8x8=64 A-tiles alone, memory holds 8
SMALL_HBM = 8 * TILE_BYTES


def _pod(**kw):
    kw.setdefault("n_devices", 2)
    kw.setdefault("mode", "sim")
    kw.setdefault("device_class", "mesh_shard")
    kw.setdefault("mesh_devices", 4)
    return kw


def _cfg(**kw):
    return RuntimeConfig(backend="numpy", device="cpu", **kw)


def _pair(**kw):
    rc = RefConfig(**kw)
    return RefRuntime(rc), BlasxRuntime(
        config_from_reference(dataclasses.asdict(rc), device="cpu"))


def _ledgers(rt):
    return {"stats": rt.stats(), "comm": rt.total_comm_bytes(),
            "launch": rt.launch_stats(), "makespan": rt.makespan()}


def _both(fn_name, args, tile=TILE, **kw):
    """Run one routine through the reference and the port on the same
    modeled machine; returns the port's output and runtime after holding
    both to each other (bitwise, ledgers exact)."""
    ref_rt, rt = _pair(**kw)
    want = getattr(ref_blas3, fn_name)(*args, tile=tile, runtime=ref_rt)
    got = getattr(blas3, fn_name)(*args, tile=tile, runtime=rt)
    assert np.array_equal(got, want)
    assert _ledgers(rt) == _ledgers(ref_rt)
    return got, rt


# ------------------------------------------------------- device classes
def test_device_class_registry_and_peaks():
    acc, mesh = DEVICE_CLASSES["accelerator"], DEVICE_CLASSES["mesh_shard"]
    assert not acc.ring and mesh.ring
    assert acc.peak_flops(1e12, 4) == 1e12
    assert mesh.peak_flops(1e12, 4) == 4e12
    assert acc.hop_bytes(1000, 4) == 0
    assert mesh.hop_bytes(1000, 4) == 750
    assert mesh.hop_bytes(1000, 1) == 0
    assert DeviceClass("x", ring=False).hop_bytes(8, 16) == 0


def test_config_validation():
    with pytest.raises(ValueError, match="device_class"):
        _cfg(device_class="tpu")
    with pytest.raises(ValueError, match="mesh_devices"):
        _cfg(device_class="mesh_shard", mesh_devices=1)
    with pytest.raises(ValueError, match="mesh_shard"):
        _cfg(mesh_devices=4)
    with pytest.raises(ValueError, match="ici_bw"):
        _cfg(ici_bw=0.0)
    cfg = _cfg(**_pod())
    assert cfg.device_peak_flops == cfg.peak_flops * 4
    assert cfg.stage_panels_on
    assert not _cfg().stage_panels_on
    assert not _cfg(**_pod(stage_panels=False)).stage_panels_on
    assert _cfg(stage_panels=True).stage_panels_on


def test_topology_fingerprint_carries_pod_fields():
    from repro_torch.tuning.model import feature_names

    base, pod = _cfg().topology(), _cfg(**_pod()).topology()
    for k in ("device_class", "mesh_devices", "ici_bw"):
        assert k in base and k in pod
    assert base["device_class"] == "accelerator"
    assert pod != base
    assert pod == RefConfig(**_pod()).topology()
    names = feature_names(pod)
    assert "topo_device_class" not in names
    assert "topo_mesh_devices" in names and "topo_ici_bw" in names
    from repro.tuning.model import feature_names as ref_feature_names
    assert names == ref_feature_names(pod)


# ------------------------------------------------------- panel planner
def test_panel_parts_triggers_only_beyond_hbm():
    cases = [((80, 100, 8), 0), ((100, 100, 8), 0), ((101, 100, 8), 3),
             ((400, 100, 8), 8), ((400, 100, 1), 0), ((400, 0, 8), 0)]
    for args, want in cases:
        assert panel_parts(*args) == want == ref_panel_parts(*args)


def _gemm_tasks(n, tile, mod=taskmod, grid=TileGrid, tiled=TiledMatrix):
    ga, gb, gc = (grid("A", n, n, tile), grid("B", n, n, tile),
                  grid("C", n, n, tile))
    grids = {"A": ga, "B": gb, "C": gc}
    tasks = mod.taskize_gemm(ga, gb, gc, "N", "N", 1.0, 0.0)
    mats = {m: tiled(g.matrix_id, np.zeros((g.rows, g.cols)), tile)
            for m, g in grids.items()}
    return tasks, grids, mats


def _task_shape(t):
    return (t.task_id, t.kind, t.parent, t.beta, t.k_range, tuple(t.deps),
            len(t.steps), t.flops)


def test_plan_panel_staged_splits_beyond_hbm_tasks():
    tasks, grids, mats = _gemm_tasks(512, TILE)
    planned = taskmod.plan_panel_staged(tasks, mats, SMALL_HBM)
    rtasks, _, rmats = _gemm_tasks(512, TILE, ref_task, RefGrid, RefTiled)
    assert [_task_shape(t) for t in planned] == [
        _task_shape(t) for t in ref_task.plan_panel_staged(
            rtasks, rmats, SMALL_HBM)]
    owners = [t for t in planned if t.kind == KIND_OWNER]
    partials = [t for t in planned if t.kind == KIND_PARTIAL]
    fixups = [t for t in planned if t.kind == KIND_FIXUP]
    assert not owners and len(fixups) == len(tasks)
    assert len(partials) == 4 * len(tasks)
    for f in fixups:
        sibs = [p for p in partials if p.parent == f.task_id]
        assert f.deps[-len(sibs):] == tuple(p.task_id for p in sibs)
        assert all(p.beta == 0.0 for p in sibs)
    small, _, smats = _gemm_tasks(128, TILE)
    assert taskmod.plan_panel_staged(small, smats, 1 << 30) == small


# --------------------------------------------- beyond-memory numerics
def test_beyond_hbm_staged_gemm_is_bitwise_identical():
    """A GEMM whose working set exceeds one device's memory runs through
    the 3-level staged path and matches the unstaged pod run, the flat
    accelerator run, the dense oracle and the reference's runs."""
    n = 512
    r = np.random.default_rng(11)
    A, B = r.standard_normal((n, n)), r.standard_normal((n, n))
    base, _ = _both("gemm", (A, B), n_devices=2, mode="sim",
                    cache_bytes=SMALL_HBM)
    staged, _ = _both("gemm", (A, B), **_pod(cache_bytes=SMALL_HBM))
    unstaged, _ = _both("gemm", (A, B), **_pod(cache_bytes=SMALL_HBM,
                                               stage_panels=False))
    assert np.array_equal(staged, unstaged)
    assert np.array_equal(staged, base)
    np.testing.assert_allclose(staged, A @ B, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("routine", ["syrk", "trsm"])
def test_pod_parity_beyond_gemm(routine):
    n = 384
    r = np.random.default_rng(12)
    A = r.standard_normal((n, n))
    if routine == "trsm":
        A = A + n * np.eye(n)
    B = r.standard_normal((n, n))
    args = (A,) if routine == "syrk" else (A, B)
    base, _ = _both(routine, args, n_devices=2, mode="sim",
                    cache_bytes=SMALL_HBM)
    pod, _ = _both(routine, args, **_pod(cache_bytes=SMALL_HBM))
    assert np.array_equal(base, pod)


# ------------------------------------------------------ ICI accounting
def test_ici_busy_equals_bytes_over_bandwidth():
    n = 512
    A = np.random.default_rng(13).standard_normal((n, n))
    _, rt = _both("gemm", (A, A), **_pod(cache_bytes=SMALL_HBM))
    total = 0
    for d in rt.devices:
        assert d.ledger.ici_bytes > 0
        np.testing.assert_allclose(
            d.ledger.ici_busy_s, d.ledger.ici_bytes / rt.cfg.ici_bw,
            rtol=1e-12)
        total += d.ledger.ici_bytes
    assert rt.total_comm_bytes()["ici"] == total


def test_accelerator_path_never_touches_ici():
    n = 512
    A = np.random.default_rng(14).standard_normal((n, n))
    _, rt = _both("gemm", (A, A), n_devices=2, mode="sim",
                  cache_bytes=SMALL_HBM)
    assert rt.total_comm_bytes()["ici"] == 0
    assert all(d.ledger.ici_busy_s == 0.0 for d in rt.devices)


def test_trace_has_ici_lane_spans():
    from repro_torch.core.events import trace_spans, validate_trace

    n = 512
    A = np.random.default_rng(15).standard_normal((n, n))
    _, rt = _both("gemm", (A, A), **_pod(cache_bytes=SMALL_HBM))
    tr = rt.trace()
    validate_trace(tr)
    assert [s for s in trace_spans(tr) if s["cat"] == "ici"]
    nbytes = sum((ev.get("args") or {}).get("nbytes", 0)
                 for ev in tr["traceEvents"]
                 if ev.get("ph") == "B" and ev.get("cat") == "ici")
    assert nbytes == rt.total_comm_bytes()["ici"]


def test_neighbor_tier_serves_ride_ici_not_pcie():
    n = 512
    A = np.random.default_rng(16).standard_normal((n, n))
    _, pod = _both("gemm", (A, A), **_pod(cache_bytes=SMALL_HBM))
    _, acc = _both("gemm", (A, A), n_devices=2, mode="sim",
                   cache_bytes=SMALL_HBM)
    assert pod.total_comm_bytes()["d2d"] == 0
    assert acc.total_comm_bytes()["d2d"] > 0


# ------------------------------------------------- staged wins deep-k
def test_staged_beats_unstaged_on_deep_k_shadow():
    """A deep-k beyond-memory DGEMM whose unique working set fits the
    pod's aggregate memory: staging beats bypassing on the virtual
    clock, with the reference's makespans."""
    from repro.core.tiling import ShadowMatrix as RefShadow
    from repro_torch.core.tiling import ShadowMatrix

    n, k, tile = 2048, 16384, 1024
    cache = 24 * tile * tile * 8
    makespans = {}
    for staged in (True, False):
        ref_rt, rt = _pair(**_pod(n_devices=4, n_streams=2,
                                  cache_bytes=cache, execute=False,
                                  record_trace=False, stage_panels=staged))
        for runtime, mod, shadow in ((rt, taskmod, ShadowMatrix),
                                     (ref_rt, ref_task, RefShadow)):
            mats = {"A": shadow("A", n, k, tile),
                    "B": shadow("B", k, n, tile),
                    "C": shadow("C", n, n, tile)}
            tasks = mod.taskize_gemm(mats["A"].grid, mats["B"].grid,
                                     mats["C"].grid, "N", "N", 1.0, 0.0)
            runtime.run(tasks, mats, "C")
        assert rt.makespan() == ref_rt.makespan()
        makespans[staged] = rt.makespan()
    assert makespans[True] < makespans[False]


# --------------------------------------------------- API knob threading
def test_context_knobs_thread_to_config_and_records():
    from repro_torch.api import BlasxContext

    r = np.random.default_rng(17)
    A = r.standard_normal((300, 200))
    B = r.standard_normal((200, 250))
    with BlasxContext(_cfg(n_devices=1, mode="sim"), mesh=4,
                      tile=TILE) as ctx:
        assert ctx.cfg.device_class == "mesh_shard"
        assert ctx.cfg.mesh_devices == 4
        out = ctx.gemm(A, B).array()
        np.testing.assert_allclose(out, A @ B, rtol=1e-10, atol=1e-10)
        rec = ctx.calls[-1]
        assert rec.ici_bytes > 0
        assert rec.input_bytes >= rec.ici_bytes
    from repro.api import BlasxContext as RefContext
    with RefContext(mesh=4, tile=TILE) as ref_ctx:
        want = ref_ctx.gemm(A, B).array()
        assert dataclasses.asdict(ref_ctx.calls[-1]) == \
            dataclasses.asdict(rec)
    assert np.array_equal(out, want)
    with BlasxContext(_cfg(n_devices=1, mode="sim"), tile=TILE) as ctx:
        ctx.gemm(A, B)
        assert ctx.calls[-1].ici_bytes == 0
    with pytest.raises(ValueError, match="runtime"):
        BlasxContext(runtime=BlasxRuntime(_cfg()), mesh=4)


def test_blas3_and_cblas_knobs():
    from repro_torch.api import BlasxContext, cblas

    r = np.random.default_rng(18)
    A = r.standard_normal((192, 160))
    B = r.standard_normal((160, 128))
    base = blas3.gemm(A, B, tile=TILE,
                      config=_cfg(n_devices=2, mode="sim"))
    pod = blas3.gemm(A, B, tile=TILE, config=_cfg(n_devices=1, mode="sim"),
                     device_class="mesh_shard", mesh=4)
    assert np.array_equal(base, pod)
    assert np.array_equal(pod, ref_blas3.gemm(
        A, B, tile=TILE, device_class="mesh_shard", mesh=4))
    C = np.zeros((192, 128))
    with BlasxContext(_cfg(n_devices=1, mode="sim"), mesh=4,
                      tile=TILE) as ctx:
        cblas.cblas_dgemm(cblas.CblasRowMajor, cblas.CblasNoTrans,
                          cblas.CblasNoTrans, 192, 128, 160, 1.0, A, 160,
                          B, 128, 0.0, C, 128, ctx=ctx, mesh=4, tile=TILE)
        assert np.array_equal(C, base)
        with pytest.raises(ValueError, match="mesh"):
            cblas._ctx(ctx, mesh=8)
        with pytest.raises(ValueError, match="device_class"):
            cblas._ctx(ctx, device_class="accelerator")
