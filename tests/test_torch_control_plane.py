"""Differential twins of the framework-free control plane.

The port carries its own copies of the heap, ALRU, MESI-X directory,
task queues and taskizers (it may import nothing of the reference).
These tests drive each pair with the same seeded operation sequences
and require identical answers at every step — heap offsets, eviction
order, coherence states, dequeue order, task lists — so a drift in
either copy shows up here before it shows up in a ledger.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import alru as ref_alru
from repro.core import coherence as ref_coh
from repro.core import heap as ref_heap
from repro.core import task as ref_task
from repro.core import taskqueue as ref_tq
from repro.core import tiling as ref_tiling
from repro_torch.core import alru, coherence, heap, task, taskqueue, tiling


@pytest.mark.parametrize("seed", range(4))
def test_heap_same_offsets_and_free_runs(seed):
    rng = np.random.default_rng(seed)
    a, b = ref_heap.BlasxHeap(4096), heap.BlasxHeap(4096)
    live = []
    for _ in range(300):
        if live and rng.random() < 0.45:
            off = live.pop(int(rng.integers(len(live))))
            a.free(off)
            b.free(off)
        else:
            size = int(rng.integers(1, 400))
            got, want = b.malloc(size), a.malloc(size)
            assert got == want
            if got is not None:
                live.append(got)
        assert (b.used, b.free_bytes, b.largest_free_run()) == \
            (a.used, a.free_bytes, a.largest_free_run())
        freeable = set(live[::2])
        assert b.largest_attainable_run(freeable) == \
            a.largest_attainable_run(freeable)
    b.check_invariants()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("quota", [None, 600])
def test_alru_same_hits_and_eviction_order(seed, quota):
    """The port's translate returns the evicted keys where the
    reference calls ``on_evict``; both must name the same victims."""
    rng = np.random.default_rng(seed)
    ra = ref_alru.Alru(0, ref_heap.BlasxHeap(2000))
    pa = alru.Alru(0, heap.BlasxHeap(2000))
    ref_evicted = []
    ra.on_evict = lambda dev, key: ref_evicted.append(key)
    if quota is not None:
        ra.set_quota("t0", quota)
        assert pa.set_quota("t0", quota) == []
    pinned = []
    for step in range(400):
        if pinned and rng.random() < 0.5:
            ikey, pkey = pinned.pop(int(rng.integers(len(pinned))))
            ra.release(ikey)
            pa.release(pkey)
            continue
        i = int(rng.integers(12))
        size = int(rng.integers(1, 5)) * 100
        owner = "t0" if quota is not None and rng.random() < 0.5 else None
        ikey = ref_tiling.TileKey("A", i, 0)
        pkey = tiling.TileKey("A", i, 0)
        ref_evicted.clear()
        want = ra.translate(ikey, size, owner=owner)
        got, evicted = pa.translate(pkey, size, owner=owner)
        assert (got is None) == (want is None), step
        assert [(k.i, k.j) for k in evicted] == \
            [(k.i, k.j) for k in ref_evicted]
        if got is not None:
            assert got.gpu_addr == want.gpu_addr
            pinned.append((ikey, pkey))
        assert (pa.hits, pa.misses, pa.evictions, pa.quota_evictions) == \
            (ra.hits, ra.misses, ra.evictions, ra.quota_evictions)
        assert [k.i for k in pa.keys()] == [k.i for k in ra.keys()]
    pa.check_invariants()


@pytest.mark.parametrize("seed", range(3))
def test_mesix_directory_same_states_and_peers(seed):
    rng = np.random.default_rng(seed)
    groups = [[0, 1], [2, 3]]
    a = ref_coh.MesixDirectory(4, groups)
    b = coherence.MesixDirectory(4, groups)
    for _ in range(400):
        i, dev = int(rng.integers(6)), int(rng.integers(4))
        ka, kb = ref_tiling.TileKey("A", i, 0), tiling.TileKey("A", i, 0)
        op = rng.integers(5)
        if op == 0:
            assert b.on_fill(kb, dev) == a.on_fill(ka, dev)
        elif op == 1:
            assert b.on_evict(kb, dev) == a.on_evict(ka, dev)
        elif op == 2:
            assert b.on_write(kb, dev) == a.on_write(ka, dev)
        elif op == 3:
            assert b.peer_holder(kb, dev) == a.peer_holder(ka, dev)
        else:
            a.mark_served(dev)
            b.mark_served(dev)
        assert b.state(kb) == a.state(ka)
        assert b.holders(kb) == a.holders(ka)
    assert (b.writebacks, b.invalidations) == (a.writebacks, a.invalidations)
    b.check_invariants()


def _tasks(mod, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for tid in range(n):
        deps = tuple(sorted({int(d) for d in rng.integers(0, tid, 2)})
                     ) if tid and rng.random() < 0.6 else ()
        out.append(mod.Task(task_id=tid, routine="gemm",
                            out=(ref_tiling if mod is ref_task else tiling
                                 ).TileKey("C", tid, 0),
                            i=tid, j=0, steps=(), alpha=1.0, beta=0.0,
                            deps=deps))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_ready_queue_and_stations_same_order(seed):
    """Dependency-gated release, reservation-station priority order,
    stealing and requeue give the same task order in both copies."""
    rng = np.random.default_rng(100 + seed)
    ta, tb = _tasks(ref_task, 40, seed), _tasks(task, 40, seed)
    qa, qb = ref_tq.ReadyQueue(ta), taskqueue.ReadyQueue(tb)
    rsa = [ref_tq.ReservationStation(d, 4) for d in range(2)]
    rsb = [taskqueue.ReservationStation(d, 4) for d in range(2)]
    prio = {t.task_id: float(rng.integers(4)) for t in ta}
    done = 0
    while not qa.drained():
        d = int(rng.integers(2))
        while rsa[d].free_slots() > 0:
            x, y = qa.try_dequeue(), qb.try_dequeue()
            assert (x and x.task_id) == (y and y.task_id)
            if x is None:
                break
            rsa[d].put(x, prio[x.task_id])
            rsb[d].put(y, prio[y.task_id])
        if len(rsa[d]) == 0:
            x = rsa[1 - d].steal(lambda t: prio[t.task_id])
            y = rsb[1 - d].steal(lambda t: prio[t.task_id])
            assert (x and x.task_id) == (y and y.task_id)
            if x is None:
                continue
            rsa[d].put(x, prio[x.task_id])
            rsb[d].put(y, prio[y.task_id])
        xs, ys = rsa[d].take_top(2), rsb[d].take_top(2)
        assert [t.task_id for t in xs] == [t.task_id for t in ys]
        if xs and rng.random() < 0.1:       # a crashed batch goes back
            qa.requeue(xs[-1])
            qb.requeue(ys[-1])
            xs, ys = xs[:-1], ys[:-1]
        for x, y in zip(xs, ys):
            qa.complete(x)
            qb.complete(y)
            done += 1
        assert qb.pending_count() == qa.pending_count()
    assert qb.drained() and done == 40


def _norm(tasks):
    """Task lists as plain data, comparable across the two packages."""
    return [repr(dataclasses.astuple(t)) for t in tasks]


@pytest.mark.parametrize("routine", ["gemm", "syrk", "syr2k", "symm",
                                     "trmm", "trsm"])
def test_taskizers_and_planners_emit_identical_tasks(routine):
    n, k, tile = 100, 70, 16

    def build(mod, tiling_mod):
        g = {name: tiling_mod.TileGrid(name, r, c, tile) for name, r, c in (
            ("A", n, k if routine in ("syrk", "syr2k") else n),
            ("B", n, k if routine == "syr2k" else n),
            ("C", n, n))}
        if routine == "gemm":
            ts = mod.taskize_gemm(g["A"], g["B"], g["C"], "N", "T", 0.5, 1.0)
        elif routine == "syrk":
            ts = mod.taskize_syrk(g["A"], g["C"], "L", "N", 1.0, 0.5)
        elif routine == "syr2k":
            ts = mod.taskize_syr2k(g["A"], g["B"], g["C"], "U", "N", 1.0,
                                   0.0)
        elif routine == "symm":
            ts = mod.taskize_symm(g["A"], g["B"], g["C"], "U", 1.0, 1.0)
        elif routine == "trmm":
            ts = mod.taskize_trmm(g["A"], g["B"], g["C"], "L", "T", "U",
                                  2.0)
        else:
            ts = mod.taskize_trsm(g["A"], g["B"], g["C"], "U", "N", "N", 1.0)
        wc = mod.plan_work_centric(ts, g, capacity=8)
        mats = {m: tiling_mod.ShadowMatrix(m, gr.rows, gr.cols, tile)
                for m, gr in g.items()}
        staged = mod.plan_panel_staged(ts, mats, 6 * tile * tile * 8)
        return ts, wc, staged

    for want, got in zip(build(ref_task, ref_tiling), build(task, tiling)):
        assert _norm(got) == _norm(want)
        assert task.total_flops(got) == ref_task.total_flops(want)
