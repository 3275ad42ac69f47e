"""The port's multi-tenant serving front end against the reference's.

Twins of ``test_serve.py``: the admission queue (bound, priority
classes, tenant round-robin, lanes, close and drain), per-tenant ALRU
quotas (each scenario runs on both packages' caches and must leave the
same blocks, owner bytes and eviction counts), tenant and priority
threading through the runtime, the MESI-X directory audit, and
``BlasxServer`` end to end on the CPU (``cuda`` backend, the GEMM
kernel's plain version).  Where a server computes, the same seeded
numpy inputs go through the reference's server too, and the results
(1e-10) and quota-eviction counts must agree.  Threads are ordered with
events; no test races a sleep against a worker.
"""
import concurrent.futures
import threading
import time
import types

import numpy as np
import pytest
import torch

import repro.core.alru as ref_alru
import repro.core.heap as ref_heap
import repro.core.tiling as ref_tiling
from repro.core.runtime import RuntimeConfig as RefConfig
from repro.serve import BlasxServer as RefServer
from repro.serve import percentile as ref_percentile
from repro_torch.api import BackpressureError, BlasxContext
from repro_torch.core.alru import Alru
from repro_torch.core.coherence import MesixDirectory
from repro_torch.core.heap import BlasxHeap
from repro_torch.core.runtime import BlasxRuntime, RuntimeConfig
from repro_torch.core.task import taskize_gemm
from repro_torch.core.tiling import TiledMatrix, TileKey
from repro_torch.serve import (BATCH, DEFAULT_BOOSTS, INTERACTIVE,
                               PRIORITY_CLASSES, AdmissionQueue, BlasxServer,
                               ServeRequest, ServerStats, percentile)

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
WAIT = 30


def _req(tenant, priority=BATCH, lane=0):
    return ServeRequest(tenant=tenant, routine="gemm", args=(), kwargs={},
                        priority=priority, lane=lane,
                        future=concurrent.futures.Future())


# ========================================================= admission queue
def test_admission_rejects_bad_priority_class_and_bounds():
    with pytest.raises(ValueError, match="priority"):
        _req("a", priority="urgent")
    with pytest.raises(ValueError, match="max_depth"):
        AdmissionQueue(max_depth=0)
    with pytest.raises(ValueError, match="n_lanes"):
        AdmissionQueue(n_lanes=0)
    assert PRIORITY_CLASSES == (INTERACTIVE, BATCH)
    assert DEFAULT_BOOSTS == {INTERACTIVE: 3.0, BATCH: 0.0}


def test_admission_depth_bound():
    q = AdmissionQueue(max_depth=2)
    assert q.offer(_req("a"))
    assert q.offer(_req("b"))
    assert not q.offer(_req("c"))      # at the bound: shed
    assert q.depth == 2 and q.lane_depth(0) == 2
    q.take()
    assert q.offer(_req("c"))          # slot freed


def test_admission_interactive_before_batch():
    q = AdmissionQueue(max_depth=8)
    first, second = _req("a", priority=BATCH), _req("b",
                                                    priority=INTERACTIVE)
    q.offer(first)
    q.offer(second)
    assert q.take() is second
    assert q.take() is first


def test_admission_tenant_round_robin_equals_the_reference():
    """Round-robin within a class, in the reference's exact order."""
    from repro.serve import AdmissionQueue as RefQueue
    from repro.serve import ServeRequest as RefRequest
    plan = ["flood", "flood", "polite", "polite", "flood", "flood",
            "third", "polite"]
    orders = []
    for Q, R in ((RefQueue, RefRequest), (AdmissionQueue, ServeRequest)):
        q = Q(max_depth=16)
        for t in plan:
            q.offer(R(tenant=t, routine="gemm", args=(), kwargs={}))
        orders.append([q.take().tenant for _ in plan])
    assert orders[0] == orders[1]
    # each tenant advances one position per turn, not FIFO's flood
    # prefix first
    assert orders[1] == ["flood", "polite", "third", "flood", "polite",
                         "flood", "polite", "flood"]


def test_admission_lanes_are_disjoint():
    q = AdmissionQueue(max_depth=8, n_lanes=2)
    r0, r1 = _req("a", lane=0), _req("a", lane=1)
    q.offer(r0)
    q.offer(r1)
    assert q.take(1, timeout=0) is r1
    assert q.take(1, timeout=0) is None
    assert q.take(0, timeout=0) is r0


def test_admission_close_drains_then_returns_none():
    q = AdmissionQueue(max_depth=8)
    a, b = _req("a"), _req("b")
    q.offer(a)
    q.offer(b)
    q.close()
    assert q.closed
    assert not q.offer(_req("c"))      # closed: refuse new work
    got = [q.take(), q.take()]
    assert (got[0] is a and got[1] is b) or (got[0] is b and got[1] is a)
    assert q.take() is None            # drained + closed: immediate


def test_admission_drain_empties_lane_and_close_wakes_takers():
    q = AdmissionQueue(max_depth=8)
    reqs = [_req("a") for _ in range(3)]
    for r in reqs:
        q.offer(r)
    assert q.drain(0) == reqs
    assert q.depth == 0
    got = []
    taker = threading.Thread(target=lambda: got.append(q.take(timeout=WAIT)))
    taker.start()
    q.close()                          # a blocked take returns None
    taker.join(timeout=WAIT)
    assert not taker.is_alive() and got == [None]


# ====================================================== ALRU tenant quotas
PKGS = {
    "ref": types.SimpleNamespace(Alru=ref_alru.Alru,
                                 BlasxHeap=ref_heap.BlasxHeap,
                                 TileKey=ref_tiling.TileKey),
    "port": types.SimpleNamespace(Alru=Alru, BlasxHeap=BlasxHeap,
                                  TileKey=TileKey),
}


def _translate(alru, key, nbytes, owner=None):
    """The block a translate returns (the port also reports the keys it
    evicted, which must match the eviction counters)."""
    out = alru.translate(key, nbytes, owner=owner)
    if isinstance(out, tuple):
        block, evicted = out
        alru.reported = getattr(alru, "reported", 0) + len(evicted)
        return block
    return out


def _fill(pkg, alru, owner, matrix_id, n, nbytes=100):
    """Cache n tiles for owner and release them (zero-reader, warm)."""
    for i in range(n):
        b = _translate(alru, pkg.TileKey(matrix_id, i, 0), nbytes, owner)
        assert b is not None
        alru.release(b.host_addr)


def _state(alru):
    keys = sorted((k.matrix_id, k.i, k.j) for k in alru.keys())
    return {"keys": keys, "quota_evictions": alru.quota_evictions,
            "by_owner": dict(alru.quota_evictions_by_owner),
            "owner_bytes": {o: alru.owner_bytes(o)
                            for o in ("a", "b", None)},
            "evictions": alru.evictions}


def _both(scenario, capacity=1000):
    """Run ``scenario(pkg, alru)`` on both packages' caches; the results
    and the final cache states must be equal.  Returns the port's."""
    out = {}
    for name, pkg in PKGS.items():
        alru = pkg.Alru(0, pkg.BlasxHeap(capacity))
        result = scenario(pkg, alru)
        alru.check_invariants()
        out[name] = (result, _state(alru), alru)
    assert out["port"][:2] == out["ref"][:2]
    port = out["port"][2]
    # every block the port's cache let go was reported to its caller
    assert getattr(port, "reported", 0) == port.evictions
    return out["port"][1]


def test_quota_flood_cannot_evict_other_tenants_set():
    def scenario(pkg, alru):
        _fill(pkg, alru, "a", "WA", 5)
        alru.set_quota("b", 300)
        _fill(pkg, alru, "b", "XB", 10)
    st = _both(scenario)
    assert all(("WA", i, 0) in st["keys"] for i in range(5))
    assert st["owner_bytes"]["a"] == 500 and st["owner_bytes"]["b"] <= 300
    assert st["quota_evictions"] >= 7
    assert st["by_owner"]["b"] == st["quota_evictions"]


def test_without_quotas_flood_evicts_the_other_tenant():
    def scenario(pkg, alru):
        _fill(pkg, alru, "a", "WA", 5)
        _fill(pkg, alru, "b", "XB", 10)
    st = _both(scenario)
    assert any(("WA", i, 0) not in st["keys"] for i in range(5))
    assert st["quota_evictions"] == 0


def test_quota_self_eviction_keeps_owner_under_cap():
    def scenario(pkg, alru):
        alru.set_quota("b", 250)
        _fill(pkg, alru, "b", "XB", 4)
    st = _both(scenario)
    assert st["owner_bytes"]["b"] == 200
    assert ("XB", 3, 0) in st["keys"] and ("XB", 0, 0) not in st["keys"]


def test_quota_oversized_request_degrades_without_eviction():
    def scenario(pkg, alru):
        alru.set_quota("b", 50)
        _fill(pkg, alru, "a", "WA", 3)
        before = alru.keys()
        got = _translate(alru, pkg.TileKey("XB", 0, 0), 100, "b")
        return got is None and alru.keys() == before
    _both(scenario)


def test_quota_all_own_blocks_pinned_degrades():
    def scenario(pkg, alru):
        alru.set_quota("b", 200)
        got = [_translate(alru, pkg.TileKey("XB", i, 0), 100, "b")
               is not None for i in range(3)]
        return got
    _both(scenario)


def test_quota_lowering_cap_trims_immediately():
    def scenario(pkg, alru):
        alru.set_quota("b", 500)
        _fill(pkg, alru, "b", "XB", 5)
        evicted = alru.set_quota("b", 150)
        if evicted is not None:            # the port reports them
            alru.reported = getattr(alru, "reported", 0) + len(evicted)
            return len(evicted)
        return alru.quota_evictions
    st = _both(scenario)
    assert st["owner_bytes"]["b"] <= 150 and st["quota_evictions"] >= 4


def test_quota_untagged_blocks_stay_evictable():
    def scenario(pkg, alru):
        _fill(pkg, alru, None, "U", 5)
        alru.set_quota("b", 300)
        return _translate(alru, pkg.TileKey("XB", 0, 0), 100,
                          "b") is not None
    st = _both(scenario, capacity=500)
    assert len([k for k in st["keys"] if k[0] == "U"]) == 4


def test_quota_removed_restores_legacy_eviction():
    def scenario(pkg, alru):
        _fill(pkg, alru, "a", "WA", 5)
        alru.set_quota("b", 300)
        alru.set_quota("b", None)
        _fill(pkg, alru, "b", "XB", 10)
    st = _both(scenario)
    assert any(("WA", i, 0) not in st["keys"] for i in range(5))


def test_quota_invariant_checker_catches_ledger_desync():
    alru = Alru(0, BlasxHeap(1000))
    _fill(PKGS["port"], alru, "a", "WA", 2)
    alru._owner_bytes["a"] = 9999           # corrupt the ledger
    with pytest.raises(RuntimeError, match="owner byte ledger"):
        alru.check_invariants()


# ======================================== runtime tenant/priority threading
def _gemm_problem(n=96, tile=32, seed=0):
    rng = np.random.default_rng(seed)
    A = TiledMatrix("A", rng.standard_normal((n, n)), tile)
    B = TiledMatrix("B", rng.standard_normal((n, n)), tile)
    C = TiledMatrix("C", np.zeros((n, n)), tile)
    tasks = taskize_gemm(A.grid, B.grid, C.grid, "N", "N", 1.0, 0.0)
    return tasks, {"A": A, "B": B, "C": C}


def _rt(**kw):
    kw.setdefault("n_devices", 1)
    return BlasxRuntime(RuntimeConfig(mode="sim", cache_bytes=8 << 20,
                                      device="cpu", **kw))


def test_run_tags_cached_blocks_with_tenant():
    rt = _rt()
    tasks, mats = _gemm_problem()
    rt.run(tasks, mats, "C", tenant="t1")
    owners = {d.alru.peek(k).owner for d in rt.devices for k in d.alru.keys()}
    assert owners == {"t1"}
    np.testing.assert_allclose(mats["C"].data.numpy(),
                               (mats["A"].data @ mats["B"].data).numpy(),
                               **TOL)


def test_priority_boost_is_additive_on_eq3():
    rt = _rt(policy="blasx")
    tasks, mats = _gemm_problem()
    rt.run(tasks, mats, "C", priority_boost=0.0)
    d, t = rt.devices[0], tasks[0]
    base = rt._priority(d, t)
    rt._boost = 2.5
    assert rt._priority(d, t) == pytest.approx(base + 2.5)


def test_run_sets_boost_for_the_duration():
    rt = _rt()
    tasks, mats = _gemm_problem(n=64)
    rt.run(tasks, mats, "C", priority_boost=3.0)
    assert rt._boost == 3.0
    rt.run(tasks, mats, "C")                # default run clears it
    assert rt._boost == 0.0 and rt._tenant is None


def test_set_tenant_quota_applies_everywhere_and_survives_reset():
    rt = _rt(n_devices=2)
    rt.set_tenant_quota("t", 1 << 20)
    assert all(d.alru.quota_of("t") == 1 << 20 for d in rt.devices)
    rt.reset()                              # rebuilds the devices
    assert all(d.alru.quota_of("t") == 1 << 20 for d in rt.devices)
    rt.set_tenant_quota("t", None)
    assert all(d.alru.quota_of("t") is None for d in rt.devices)
    assert "quota_evictions" in rt.stats()["device0"]


def test_lowered_quota_frees_the_evicted_tiles_device_copies():
    """Blocks evicted to get under a lowered cap leave the tile store
    and the directory, so their device memory is freed."""
    rt = _rt(n_devices=2)
    tasks, mats = _gemm_problem()
    rt.run(tasks, mats, "C", tenant="t")
    before = sum(len(d.store) for d in rt.devices)
    assert before > 0
    rt.set_tenant_quota("t", 2 * 32 * 32 * 8)    # two f64 tiles a device
    for d in rt.devices:
        assert set(d.store) == set(d.alru.keys())
        assert d.alru.owner_bytes("t") <= 2 * 32 * 32 * 8
    assert sum(len(d.store) for d in rt.devices) < before
    rt.directory.audit([d.alru for d in rt.devices])


def test_quota_ledgers_equal_the_reference_runtime():
    """A tenant-tagged run under a tight quota evicts exactly as the
    reference runtime does."""
    from repro.core.runtime import BlasxRuntime as RefRuntime
    from repro.core.task import taskize_gemm as ref_taskize_gemm
    from repro.core.tiling import TiledMatrix as RefTiled
    rng = np.random.default_rng(1)
    A, B = rng.standard_normal((128, 128)), rng.standard_normal((128, 128))
    results = []
    for Rt, Tiled, taskize, cfg in (
            (RefRuntime, RefTiled, ref_taskize_gemm,
             RefConfig(n_devices=2, mode="sim", cache_bytes=8 << 20)),
            (BlasxRuntime, TiledMatrix, taskize_gemm,
             RuntimeConfig(n_devices=2, mode="sim", cache_bytes=8 << 20,
                           device="cpu"))):
        rt = Rt(cfg)
        rt.set_tenant_quota("t", 3 * 32 * 32 * 8)
        mats = {"A": Tiled("A", A, 32), "B": Tiled("B", B, 32),
                "C": Tiled("C", np.zeros((128, 128)), 32)}
        tasks = taskize(mats["A"].grid, mats["B"].grid, mats["C"].grid,
                        "N", "N", 1.0, 0.0)
        rt.run(tasks, mats, "C", tenant="t", priority_boost=3.0)
        results.append(([dict(d.alru.quota_evictions_by_owner)
                         for d in rt.devices], rt.total_comm_bytes(),
                        rt.makespan(), np.asarray(mats["C"].data)))
    assert results[0][:3] == results[1][:3]
    assert sum(n.get("t", 0) for n in results[1][0]) > 0
    np.testing.assert_allclose(results[1][3], A @ B, **TOL)


# ======================================================== directory audit
def test_directory_audit_passes_after_runs():
    rt = _rt(n_devices=2)
    tasks, mats = _gemm_problem()
    rt.run(tasks, mats, "C", tenant="t1")
    rt.directory.audit([d.alru for d in rt.devices])


def test_directory_audit_detects_desync_both_ways():
    directory = MesixDirectory(1, [[0]])
    alru = Alru(0, BlasxHeap(1000))
    key = TileKey("A", 0, 0)
    directory.on_fill(key, 0)               # directory-only: no block
    with pytest.raises(RuntimeError, match="ALRU has no such block"):
        directory.audit([alru])
    directory.on_evict(key, 0)
    b, _ = alru.translate(key, 100)         # cache-only: no holder entry
    alru.release(b.host_addr)
    with pytest.raises(RuntimeError, match="does not list it"):
        directory.audit([alru])


# ============================================================ BlasxServer
def _cfg(pkg="port", **kw):
    kw.setdefault("n_devices", 1)
    kw.setdefault("mode", "sim")
    kw.setdefault("cache_bytes", 8 << 20)
    if pkg == "ref":
        return RefConfig(**kw)
    return RuntimeConfig(device="cpu", **kw)


def _server(pool_size=2, pkg="port", **kw):
    cfg = kw.pop("cfg", None) or _cfg(pkg)
    kw.setdefault("tile", 32)
    cls = RefServer if pkg == "ref" else BlasxServer
    return cls(cfg, pool_size=pool_size, **kw)


def _stall(srv, tenant="t"):
    """Occupy ``tenant``'s home lane until the returned gate is set."""
    gate, running = threading.Event(), threading.Event()
    f = srv.submit(tenant,
                   lambda ctx: (running.set(), gate.wait(WAIT)) and "held")
    assert running.wait(WAIT)
    return gate, f


def test_server_serves_correct_results_to_two_tenants():
    rng = np.random.default_rng(2)
    a1, b1 = rng.standard_normal((64, 48)), rng.standard_normal((48, 80))
    a2, b2 = rng.standard_normal((96, 64)), rng.standard_normal((64, 32))
    outs = {}
    for pkg in ("ref", "port"):
        with _server(pkg=pkg) as srv:
            f1 = srv.submit("t1", "gemm", a1, b1, priority=INTERACTIVE)
            f2 = srv.submit("t2", "gemm", a2, b2)
            outs[pkg] = (f1.result(timeout=WAIT).array(),
                         f2.result(timeout=WAIT).array())
            st = srv.stats()
            assert st["tenants"]["t1"]["completed"] == 1
            assert st["tenants"]["t2"]["completed"] == 1
    np.testing.assert_allclose(outs["port"][0], a1 @ b1, **TOL)
    np.testing.assert_allclose(outs["port"][1], a2 @ b2, **TOL)
    for got, want in zip(outs["port"], outs["ref"]):
        np.testing.assert_allclose(got, want, **TOL)


def test_server_affinity_keeps_tenant_on_one_context():
    with _server() as srv:
        seen = {srv.submit("sticky", lambda ctx: id(ctx)).result(
            timeout=WAIT) for _ in range(4)}
        assert len(seen) == 1
        assert id(srv._contexts[srv.context_of("sticky")]) in seen
        assert srv.context_of("nobody") is None


def test_server_handles_pin_requests_to_their_context():
    rng = np.random.default_rng(3)
    with _server() as srv:
        w = srv.tile("t1", rng.standard_normal((64, 64)))
        home = srv.context_of("t1")
        x = rng.standard_normal((48, 64))
        got = srv.submit("t1", "gemm", x, w).result(timeout=WAIT)
        np.testing.assert_allclose(got.array(), x @ w.array(), **TOL)
        assert srv.context_of("t1") == home
        # a handle pins a new tenant to the handle's context too
        srv.submit("t2", "gemm", x, w).result(timeout=WAIT)
        assert srv.context_of("t2") == home
        with BlasxContext(_cfg()) as other:
            with pytest.raises(ValueError, match="outside this server"):
                srv.submit("t1", "gemm", x, other.tile(np.eye(64)))


def test_server_overflow_routes_to_least_loaded_context():
    """overflow_depth=0: with the home lane held by a gated request
    (its load stays 1 until the gate opens) the next request goes to
    the idle lane; affinity stays."""
    with _server(overflow_depth=0) as srv:
        gate, stalled = _stall(srv)
        try:
            home = srv.context_of("t")
            f = srv.submit("t", lambda ctx: id(ctx))
            assert f.result(timeout=WAIT) == id(srv._contexts[1 - home])
            assert srv.context_of("t") == home
        finally:
            gate.set()
        assert stalled.result(timeout=WAIT) == "held"


def test_server_without_overflow_queues_behind_home_lane():
    with _server(overflow_depth=100) as srv:
        gate, stalled = _stall(srv)
        home = srv.context_of("t")
        f = srv.submit("t", lambda ctx: id(ctx))
        assert not f.done()                  # stuck behind the gate
        assert srv.stats()["lane_load"][home] == 2
        gate.set()
        assert f.result(timeout=WAIT) == id(srv._contexts[home])
        assert stalled.result(timeout=WAIT) == "held"


def test_server_sheds_load_with_backpressure_error():
    with _server(pool_size=1, max_depth=2) as srv:
        gate, stalled = _stall(srv, "a")     # worker busy; queue empty
        q1 = srv.submit("a", lambda ctx: 1)
        q2 = srv.submit("b", lambda ctx: 2)
        with pytest.raises(BackpressureError, match="max_depth=2"):
            srv.submit("c", lambda ctx: 3)
        assert srv.stats()["queue_depth"] == 2
        gate.set()
        assert (q1.result(timeout=WAIT), q2.result(timeout=WAIT)) == (1, 2)
        stalled.result(timeout=WAIT)
        st = srv.stats()["tenants"]
        assert st["c"]["rejected"] == 1 and st["c"]["completed"] == 0


def test_server_cancels_queued_requests():
    """A cancelled request is counted when its lane's worker dequeues
    it, which a later request on the same lane orders after."""
    with _server(pool_size=1) as srv:
        gate, stalled = _stall(srv, "a")
        doomed = srv.submit("a", lambda ctx: 1)
        after = srv.submit("a", lambda ctx: "after")
        assert doomed.cancel() and doomed.cancelled()
        with pytest.raises(concurrent.futures.CancelledError):
            doomed.result(timeout=1)
        gate.set()
        assert stalled.result(timeout=WAIT) == "held"
        assert after.result(timeout=WAIT) == "after"
        assert srv.stats()["tenants"]["a"]["cancelled"] == 1


def _flood_scenario(pkg, quotas):
    """Tenant a warms two handles; tenant b floods ephemeral traffic.
    Returns a's resident keys before and after, b's quota evictions and
    the server's eviction ledger."""
    rng = np.random.default_rng(4)
    X, W = rng.standard_normal((128, 128)), rng.standard_normal((128, 128))
    big = rng.standard_normal((256, 256))
    cfg = _cfg(pkg, cache_bytes=1 << 20)
    with _server(pool_size=1, pkg=pkg, cfg=cfg, quotas=quotas) as srv:
        x, w = srv.tile("a", X), srv.tile("a", W)
        srv.submit("a", "gemm", x, w).result(timeout=WAIT)
        ctx = srv._contexts[0]

        def resident():
            return {(k.i, k.j, k.matrix_id == x.matrix_id)
                    for d in ctx.runtime.devices for k in d.alru.keys()
                    if k.matrix_id in (x.matrix_id, w.matrix_id)}

        before = resident()
        for _ in range(3):
            out = srv.submit("b", "gemm", big, big).result(timeout=WAIT)
        np.testing.assert_allclose(out.array(), big @ big, **TOL)
        for d in ctx.runtime.devices:
            d.alru.check_invariants()
            if pkg == "port":
                assert set(d.store) <= set(d.alru.keys())
        ctx.runtime.directory.audit([d.alru for d in ctx.runtime.devices])
        return (before, resident(), srv.quota_evictions(),
                srv.stats()["tenants"]["b"]["quota_evictions"])


def test_server_quota_isolation_end_to_end():
    """Tenant a's warm set survives tenant b's quota'd flood, with the
    reference's eviction counts."""
    got = _flood_scenario("port", {"b": 256 << 10})
    assert got == _flood_scenario("ref", {"b": 256 << 10})
    before, after, evictions, b_row = got
    assert before and after == before
    assert evictions.get("b", 0) > 0 and b_row > 0
    assert evictions.get("a", 0) == 0


def test_server_flood_evicts_warm_set_without_quota():
    got = _flood_scenario("port", None)
    assert got == _flood_scenario("ref", None)
    before, after, evictions, _ = got
    assert after < before and evictions == {}


def test_server_stats_shape_and_percentiles():
    with _server() as srv:
        for _ in range(3):
            srv.submit("t", lambda ctx: None).result(timeout=WAIT)
        st = srv.stats()
        row = st["tenants"]["t"]
        assert set(row) == {"completed", "failed", "rejected", "cancelled",
                            "latency_p50_ms", "latency_p99_ms",
                            "queue_wait_p50_ms", "queue_wait_p99_ms",
                            "quota_evictions"}
        assert row["completed"] == 3
        assert row["latency_p99_ms"] >= row["latency_p50_ms"] >= 0.0
        assert st["pool_size"] == 2 and set(st) == {
            "pool_size", "queue_depth", "lane_load", "affinity", "tenants"}


def test_server_routine_errors_surface_and_count_as_failed():
    with _server() as srv:
        def boom(ctx):
            raise ValueError("kaput")
        with pytest.raises(ValueError, match="kaput"):
            srv.submit("t", boom).result(timeout=WAIT)
        with pytest.raises(ValueError, match="unknown routine"):
            srv.submit("t", "no_such_routine").result(timeout=WAIT)
        assert srv.stats()["tenants"]["t"]["failed"] == 2
        assert srv.submit("t", lambda ctx: 5).result(timeout=WAIT) == 5


def test_server_close_waits_then_rejects():
    srv = _server()
    f = srv.submit("t", lambda ctx: 7)
    srv.close()
    assert srv.closed
    assert f.result(timeout=1) == 7          # queued work drained
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("t", lambda ctx: 8)
    with pytest.raises(RuntimeError, match="closed"):
        srv.tile("t", np.eye(4))
    srv.close()                              # idempotent
    assert all(ctx.closed for ctx in srv._contexts)


def test_server_close_without_wait_cancels_queued_work():
    srv = _server(pool_size=1)
    gate, stalled = _stall(srv)
    queued = [srv.submit("t", lambda ctx: 1) for _ in range(3)]
    closer = threading.Thread(target=srv.close, kwargs={"wait": False})
    closer.start()
    deadline = time.monotonic() + WAIT
    while not all(f.cancelled() for f in queued) and \
            time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    closer.join(timeout=WAIT)
    assert not closer.is_alive()
    assert all(f.cancelled() for f in queued)
    assert stalled.result(timeout=WAIT) == "held"
    assert srv.stats()["tenants"]["t"]["cancelled"] == 3


def test_server_adopted_contexts_survive_close_and_validation():
    with BlasxContext(_cfg()) as ctx:
        srv = BlasxServer(contexts=[ctx])
        srv.submit("t", lambda c: None).result(timeout=WAIT)
        srv.close()
        assert not ctx.closed
        np.testing.assert_allclose(ctx.gemm(np.eye(8), np.eye(8)).array(),
                                   np.eye(8))
        with pytest.raises(ValueError, match="not both"):
            BlasxServer(_cfg(), contexts=[ctx])
    with pytest.raises(ValueError, match="non-empty"):
        BlasxServer(contexts=[])
    with pytest.raises(ValueError, match="pool_size"):
        BlasxServer(_cfg(), pool_size=0)
    with pytest.raises(ValueError, match="priority class"):
        BlasxServer(_cfg(), priority_boosts={"urgent": 1.0})


def test_server_default_config_needs_a_card():
    """The default pooled contexts compute on the card: without one
    the server refuses to start instead of serving from the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        BlasxServer(pool_size=1)
    from repro_torch.serve.__main__ import main
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        main(["--demo"])                     # --device defaults to cuda


def test_server_demo_runs_on_the_host(capsys):
    from repro_torch.serve.__main__ import main
    assert main(["--demo", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "demo OK" in out and "device=cpu" in out
    assert main([]) == 2


def test_percentile_nearest_rank():
    for samples, q in (([], 99.0), ([5.0], 50.0), ([1.0, 2.0, 3.0, 4.0], 50.0),
                       ([1.0, 2.0, 3.0, 4.0], 99.0), ([3.0, 1.0, 2.0], 0.0)):
        assert percentile(samples, q) == ref_percentile(samples, q)
    assert percentile([1.0, 2.0, 3.0, 4.0], 50.0) == 2.0


def test_server_stats_ledger_direct():
    st = ServerStats(window=4)
    st.record("t", wait_s=0.001, latency_s=0.002, ok=True)
    st.record("t", wait_s=0.002, latency_s=0.004, ok=False)
    st.record_rejection("t")
    st.record_cancelled("t")
    snap = st.snapshot({"t": 3, "ghost": 1})
    assert (snap["t"]["completed"], snap["t"]["failed"],
            snap["t"]["rejected"], snap["t"]["cancelled"]) == (1, 1, 1, 1)
    assert snap["t"]["quota_evictions"] == 3
    assert snap["ghost"]["quota_evictions"] == 1
    assert snap["t"]["latency_p50_ms"] == pytest.approx(2.0)
    assert st.tenant_p99("t") == pytest.approx(0.004)
    assert st.tenant_p99("nobody") == 0.0
    for _ in range(10):                      # the window keeps the last 4
        st.record("t", wait_s=0.0, latency_s=1.0, ok=True)
    assert st.snapshot()["t"]["latency_p50_ms"] == pytest.approx(1e3)


def test_server_stats_counts_are_exact_under_racing_recorders():
    """Eight threads record 500 results each with a short switch
    interval; the counters lose no update."""
    import sys
    st = ServerStats()
    barrier = threading.Barrier(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def recorder(i):
            barrier.wait(WAIT)
            for k in range(500):
                st.record(f"t{i % 2}", 0.0, 0.001, ok=k % 5 != 0)
                st.record_rejection(f"t{i % 2}")
        threads = [threading.Thread(target=recorder, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = st.snapshot()
    for t in ("t0", "t1"):
        assert snap[t]["completed"] + snap[t]["failed"] == 2000
        assert snap[t]["failed"] == 400 and snap[t]["rejected"] == 2000


def test_chip_smoke_api_phase_runs_on_the_host(capsys):
    """``chip_smoke.py``'s api phase (CBLAS, submit, batched, tuned and
    served GEMMs) end to end on the CPU at a tiny size: every check in
    it passes and its JSON line holds each part's numbers."""
    import importlib.util
    import json
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_api", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    small = {"cblas_n": 96, "pad": 5, "cblas_time_n": 128, "chain_n": 96,
             "batch_n": 64, "tune_n": 128, "serve_n": 96, "tile": 32,
             "serve_cache": 8 << 20, "quota": 32 << 10,
             "requests": {"app": 4, "flood": 6, "f64": 3}}
    out, launches = smoke.phase_api("cpu", device="cpu", sizes=small)
    assert launches == {}                    # the plain versions ran
    assert len(out["cblas"]) == 12
    assert out["batched"]["h2d_bytes"][1] < out["batched"]["h2d_bytes"][0]
    assert out["tuned"]["report"]["bucket_sweeps"] == 1
    tenants = out["server"]["tenants"]
    assert tenants["flood"]["quota_evictions"] > 0
    assert tenants["app"]["quota_evictions"] == 0
    assert [t["completed"] for t in tenants.values()] == [4, 6, 3]
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"api"')]
    assert json.loads(line[0])["api"]["server"]["n"] == 96
