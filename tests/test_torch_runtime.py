"""Exact schedule parity between the port's runtime and the reference's.

The sim runtime is deterministic and its ledger does not depend on the
framework, so for the same configuration — built for the port from the
reference's with ``config_from_reference`` — both runtimes must report
the same h2d/d2d/d2h/ici bytes, kernel launches, batched groups and
steps, per-device clocks and ledgers, makespan and Chrome-trace spans,
with only the engine names mapped ``jax -> torch``, ``pallas -> cuda``.
The same numpy matrices go to both.
"""
import dataclasses
import itertools
import json
import re

import numpy as np
import pytest
import torch

from repro.core import blas3 as ref_blas3
from repro.core.runtime import BlasxRuntime as RefRuntime
from repro.core.runtime import RuntimeConfig as RefConfig
from repro_torch.core import blas3
from repro_torch.core.alru import Alru
from repro_torch.core.heap import BlasxHeap
from repro_torch.core.runtime import BlasxRuntime, config_from_reference
from repro_torch.core.tiling import TiledMatrix, TileKey

# one intra-op thread: the suite runs several worker processes at
# once, and this process's idle OpenMP threads would otherwise spin
# on cores the other workers' timing-sensitive threads-mode tests need
torch.set_num_threads(1)

ENGINE = {"jax": "torch", "pallas": "cuda"}
M, N, K, TILE = 72, 56, 88, 16   # ragged edges in every dimension


def _port(ref_cfg):
    return BlasxRuntime(config_from_reference(dataclasses.asdict(ref_cfg),
                                              device="cpu"))


def _canonical_ids(events):
    """Trace events with handle ids (``M<n>``, drawn from a per-package
    process-wide counter) renumbered by first appearance, so runs that
    follow other tests in the same process still compare equal."""
    seen = {}
    text = re.sub(r"\bM\d+\b",
                  lambda m: seen.setdefault(m.group(0), f"M#{len(seen)}"),
                  json.dumps(events))
    return json.loads(text)


def _snapshot(rt, engines=None):
    """Everything the schedule determines, engine names mapped."""
    engines = engines or {}
    stats = rt.stats()
    for dev in stats.values():
        dev["engine_flops"] = {engines.get(e, e): f
                               for e, f in dev["engine_flops"].items()}
    launch = dict(rt.launch_stats())
    launch.pop("backend")
    launch["engine_flops"] = {engines.get(e, e): f
                              for e, f in launch["engine_flops"].items()}
    trace = rt.trace()
    other = dict(trace["otherData"])
    other.pop("backend")
    return {"stats": stats, "launch": launch,
            "comm": rt.total_comm_bytes(), "makespan": rt.makespan(),
            "events": _canonical_ids(trace["traceEvents"]), "other": other}


def _assert_same_schedule(ref_rt, rt):
    want, got = _snapshot(ref_rt, ENGINE), _snapshot(rt)
    for key in ("comm", "makespan", "launch", "other", "stats"):
        assert got[key] == want[key], key
    assert len(got["events"]) == len(want["events"])
    assert got["events"] == want["events"]


def _mats(seed=0, dtype=np.float64):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, K)).astype(dtype),
            r.standard_normal((K, N)).astype(dtype))


POLICIES = ("blasx", "parsec", "cublasxt", "static", "supermatrix")


@pytest.mark.parametrize(
    "policy,time_model,work_centric",
    list(itertools.product(POLICIES, ("events", "lump"), (False, True))))
def test_ledger_parity_policy_matrix(policy, time_model, work_centric):
    A, B = _mats()
    ref_cfg = RefConfig(n_devices=2, backend="jax", policy=policy,
                        time_model=time_model, work_centric=work_centric,
                        cache_bytes=40 * TILE * TILE * 8)
    ref_rt, rt = RefRuntime(ref_cfg), _port(ref_cfg)
    want = ref_blas3.gemm(A, B, tile=TILE, runtime=ref_rt)
    got = blas3.gemm(A, B, tile=TILE, runtime=rt)
    _assert_same_schedule(ref_rt, rt)
    # the reference's jax backend computes f64 in f32; the port in f64
    np.testing.assert_allclose(got, A @ B, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("routine", ["gemm", "syrk", "syr2k", "symm",
                                     "trmm", "trsm"])
def test_ledger_parity_every_routine_pallas_routing(routine):
    """The six taskizers and the kernel/fallback routing, with the
    reference on its Pallas backend (interpret mode)."""
    r = np.random.default_rng(3)
    n = 48
    A = r.standard_normal((n, n)).astype(np.float32)
    B = r.standard_normal((n, n)).astype(np.float32)
    if routine == "trsm":
        A = A + n * np.eye(n, dtype=np.float32)
    args = (A,) if routine == "syrk" else (A, B)
    ref_cfg = RefConfig(n_devices=2, backend="pallas")
    ref_rt, rt = RefRuntime(ref_cfg), _port(ref_cfg)
    want = getattr(ref_blas3, routine)(*args, tile=TILE, runtime=ref_rt)
    got = getattr(blas3, routine)(*args, tile=TILE, runtime=rt)
    _assert_same_schedule(ref_rt, rt)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_ledger_parity_mesh_shard_beyond_hbm():
    """The pod tier: ring devices, ICI lane, panel staging of tasks
    whose working set exceeds the (tiny) HBM."""
    tile = 64
    r = np.random.default_rng(9)
    A = r.standard_normal((512, 512))
    ref_cfg = RefConfig(n_devices=2, backend="jax",
                        device_class="mesh_shard", mesh_devices=4,
                        cache_bytes=8 * tile * tile * 8)
    ref_rt, rt = RefRuntime(ref_cfg), _port(ref_cfg)
    ref_blas3.gemm(A, A, tile=tile, runtime=ref_rt)
    got = blas3.gemm(A, A, tile=tile, runtime=rt)
    assert rt.total_comm_bytes()["ici"] > 0
    _assert_same_schedule(ref_rt, rt)
    np.testing.assert_allclose(got, A @ A, rtol=1e-10, atol=1e-10)


def test_ledger_parity_across_a_warm_session():
    """Caches, clocks and ledgers persist across calls of one runtime
    exactly as in the reference (including after reset_stats)."""
    A, B = _mats(4)
    ref_cfg = RefConfig(n_devices=3, backend="jax")
    ref_rt, rt = RefRuntime(ref_cfg), _port(ref_cfg)
    for _ in range(2):
        ref_blas3.gemm(A, B, tile=TILE, runtime=ref_rt)
        blas3.gemm(A, B, tile=TILE, runtime=rt)
    _assert_same_schedule(ref_rt, rt)
    ref_rt.reset_stats()
    rt.reset_stats()
    ref_blas3.syrk(A, tile=TILE, runtime=ref_rt)
    blas3.syrk(A, tile=TILE, runtime=rt)
    _assert_same_schedule(ref_rt, rt)


def test_shadow_run_parity_at_paper_scale():
    """N=16384, T=1024 DGEMM (the paper's Fig. 7/10 regime) as a
    metadata-only run: identical schedule, no numerics."""
    ref_cfg = RefConfig(n_devices=2, execute=False, record_trace=True)
    ref_rt, rt = RefRuntime(ref_cfg), _port(dataclasses.replace(
        ref_cfg, backend="jax"))
    ref_blas3.shadow_run("gemm", 16384, tile=1024, runtime=ref_rt)
    blas3.shadow_run("gemm", 16384, tile=1024, runtime=rt)
    want, got = _snapshot(ref_rt), _snapshot(rt)
    assert got["comm"] == want["comm"] and got["makespan"] == want["makespan"]
    assert got["stats"] == want["stats"]
    assert got["events"] == want["events"]
    assert got["launch"]["tasks"] == 256


def test_threads_mode_numerics_and_task_accounting():
    """Threads mode measures wall time, so only the work done — not who
    did it — is deterministic: every task runs once and the result is
    the product."""
    A, B = _mats(5)
    for backend in ("jax", "pallas"):
        ref_cfg = RefConfig(n_devices=2, backend=backend, mode="threads")
        rt = _port(ref_cfg)
        got = blas3.gemm(A, B, tile=TILE, runtime=rt)
        np.testing.assert_allclose(got, A @ B, rtol=1e-12, atol=1e-12)
        ls = rt.launch_stats()
        assert ls["tasks"] == 5 * 4          # ceil(72/16) x ceil(56/16)
        assert sum(d.ledger.d2h_bytes for d in rt.devices) == M * N * 8


def test_d2d_served_seconds_balance_requester_charge():
    """The serving side's P2P seconds (charged through each device's
    locked meter) equal the requesters' d2d seconds, as in the
    reference."""
    A, B = _mats(6)
    ref_cfg = RefConfig(n_devices=4, backend="jax", time_model="lump")
    rt = _port(ref_cfg)
    blas3.gemm(A, B, tile=TILE, runtime=rt)
    served = sum(d.ledger.d2d_served_s for d in rt.devices)
    d2d = sum(d.ledger.d2d_bytes for d in rt.devices)
    assert d2d > 0
    np.testing.assert_allclose(served, d2d / rt.cfg.d2d_bw, rtol=1e-12)


# ------------------------------------------------ ALRU eviction contract
def test_alru_translate_reports_evictions_instead_of_calling_back():
    heap = BlasxHeap(300)
    alru = Alru(0, heap)
    keys = [TileKey("A", i, 0) for i in range(4)]
    for key in keys[:3]:
        block, evicted = alru.translate(key, 100)
        assert block is not None and evicted == []
        alru.release(key)
    block, evicted = alru.translate(keys[3], 100)
    assert evicted == [keys[0]]            # the LRU victim
    assert keys[0] not in alru
    alru.check_invariants()
    # a pinned cache degrades without evicting anything
    for key in keys[1:]:
        alru.translate(key, 100)
    block, evicted = alru.translate(TileKey("B", 0, 0), 100)
    assert block is None and evicted == []


def test_alru_quota_trim_reports_evictions():
    alru = Alru(0, BlasxHeap(1000))
    for i in range(4):
        key = TileKey("A", i, 0)
        alru.translate(key, 100, owner="t")
        alru.release(key)
    evicted = alru.set_quota("t", 200)
    assert evicted == [TileKey("A", 0, 0), TileKey("A", 1, 0)]
    assert alru.owner_bytes("t") == 200


def test_runtime_syncs_directory_and_store_with_reported_evictions():
    """After a run under cache pressure, the directory lists exactly the
    tiles the ALRUs hold and every store entry is a resident tile."""
    A, B = _mats(7)
    ref_cfg = RefConfig(n_devices=2, backend="jax",
                        cache_bytes=6 * TILE * TILE * 8)
    rt = _port(ref_cfg)
    blas3.gemm(A, B, tile=TILE, runtime=rt)
    assert sum(d.alru.evictions for d in rt.devices) > 0
    rt.directory.audit([d.alru for d in rt.devices])
    for d in rt.devices:
        assert set(d.store) <= set(d.alru.keys())


def test_tiles_are_copied_to_the_device_and_written_back():
    data = np.arange(12.0).reshape(3, 4)
    tm = TiledMatrix("A", data, 2)
    assert np.shares_memory(tm.data.numpy(), data)   # no copy on tiling
    t = tm.read_tile(1, 1)
    tm.write_tile(1, 1, t * 2)
    assert data[2, 2] == 20.0 and data[2, 3] == 22.0
    rt = BlasxRuntime(config_from_reference(
        dataclasses.asdict(RefConfig(backend="jax")), device="cpu"))
    copy = rt._to_device(tm.read_tile(0, 0))
    assert not np.shares_memory(copy.numpy(), data)
    assert copy.device == torch.device("cpu")


def test_l2_serve_shares_the_peers_tensor():
    """An L2 (P2P) serve hands the peer's device tensor over without a
    copy, as the reference hands over its array."""
    from repro_torch.core import task as taskmod

    A, B = _mats(8)
    rt = _port(RefConfig(n_devices=2, backend="jax"))
    mats = {"A": TiledMatrix("A", A, TILE), "B": TiledMatrix("B", B, TILE),
            "C": TiledMatrix("C", np.zeros((M, N)), TILE)}
    tasks = taskmod.taskize_gemm(mats["A"].grid, mats["B"].grid,
                                 mats["C"].grid, "N", "N", 1.0, 0.0)
    rt.run(tasks, mats, "C")
    assert rt.total_comm_bytes()["d2d"] > 0
    s0, s1 = rt.devices[0].store, rt.devices[1].store
    assert any(s0[k] is s1[k] for k in s0 if k in s1)
    np.testing.assert_allclose(mats["C"].data.numpy(), A @ B, rtol=1e-12)
