"""Hypothesis property tests of the port's invariants, against the
reference.

Twins of ``test_property.py`` with the reference's ``max_examples``:
heap arena integrity, ALRU pinning discipline, MESI-X single-writer
consistency, taskization flop accounting and tiled-GEMM correctness over
random shapes.  Every drawn trace also runs through the reference's
structure, and the two must agree step for step.  The port's ALRU
returns its evicted keys from ``translate`` (its callers drop them from
the directory outside the cache lock) where the reference fires
``on_evict`` under it; the twins hold the two eviction sequences equal.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -e .[test])")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import gemm as ref_gemm  # noqa: E402
from repro.core.alru import Alru as RefAlru  # noqa: E402
from repro.core.coherence import MesixDirectory as RefDirectory  # noqa: E402
from repro.core.heap import BlasxHeap as RefHeap  # noqa: E402
from repro.core.runtime import RuntimeConfig as RefConfig  # noqa: E402
from repro.core.task import taskize_gemm as ref_taskize_gemm  # noqa: E402
from repro.core.tiling import TileGrid as RefGrid  # noqa: E402
from repro.core.tiling import TileKey as RefKey  # noqa: E402
from repro_torch.core import gemm  # noqa: E402
from repro_torch.core.alru import Alru  # noqa: E402
from repro_torch.core.coherence import MesixDirectory  # noqa: E402
from repro_torch.core.heap import BlasxHeap  # noqa: E402
from repro_torch.core.runtime import RuntimeConfig  # noqa: E402
from repro_torch.core.task import taskize_gemm, total_flops  # noqa: E402
from repro_torch.core.tiling import TileGrid, TileKey  # noqa: E402

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)


# ------------------------------------------------------------------- heap
@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.integers(1, 400)),
                min_size=1, max_size=120))
def test_heap_invariants_under_random_traces(ops):
    """After any alloc/free trace: segments exactly tile the arena, free
    neighbours are coalesced, accounting is consistent — and every
    allocation lands where the reference's does."""
    h, ref = BlasxHeap(4096), RefHeap(4096)
    live, ref_live = [], []
    for is_alloc, size in ops:
        if is_alloc or not live:
            off = h.malloc(size)
            assert off == ref.malloc(size)
            if off is not None:
                live.append(off)
                ref_live.append(off)
        else:
            idx = len(live) % max(1, len(live)) - 1
            h.free(live.pop(idx))
            ref.free(ref_live.pop(idx))
        h.check_invariants()
        assert h.used == ref.used
    for off in live:
        h.free(off)
    h.check_invariants()
    assert h.free_bytes == 4096


# ------------------------------------------------------------------- ALRU
@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(0, 15), min_size=1, max_size=80),
       st.integers(2, 6))
def test_alru_never_evicts_pinned_blocks(accesses, cap_tiles):
    """The A in ALRU: a block with readers > 0 survives any sequence of
    other translations."""
    a = Alru(0, BlasxHeap(cap_tiles * 100))
    pinned = TileKey("P", 0, 0)
    blk, evicted = a.translate(pinned, 100)   # reader = 1, never released
    assert blk is not None and evicted == []
    for t in accesses:
        key = TileKey("A", 0, t)
        b, evicted = a.translate(key, 100)
        assert pinned not in evicted
        if b is not None and key != pinned:
            a.release(key)
        a.check_invariants()
        assert pinned in a


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 11),          # tile identity
                          st.sampled_from([60, 100, 140, 220]),  # nbytes
                          st.booleans()),               # release after?
                min_size=1, max_size=100))
def test_alru_fragmented_heap_translate_invariants(ops):
    """Drive a fragmented heap (mixed tile sizes, some tiles left
    pinned) through the port's and the reference's ``translate``.  At
    every step: the port evicts exactly what the reference's
    ``on_evict`` reports, in the same order; no over-eviction (a failed
    translate evicts nothing); heap.used equals the resident bytes, the
    victims' bytes freed before the caller hears of them; structural
    invariants hold."""
    heap, ref_heap = BlasxHeap(500), RefHeap(500)
    a, ref = Alru(0, heap), RefAlru(0, ref_heap)
    ref_evicted = []
    ref.on_evict = lambda dev, key: ref_evicted.append(
        (key.matrix_id, key.i, key.j))
    mirror = {}           # key -> nbytes, kept from translate's evictions
    pinned = set()
    for ident, nbytes, release in ops:
        key, rkey = TileKey("T", 0, ident), RefKey("T", 0, ident)
        before = dict(mirror)
        if key in a:                       # hit path: sizes stay stable
            nbytes = a.peek(key).nbytes
        ref_evicted.clear()
        blk, evicted = a.translate(key, nbytes)
        ref_blk = ref.translate(rkey, nbytes)
        assert [(k.matrix_id, k.i, k.j) for k in evicted] == ref_evicted
        assert (blk is None) == (ref_blk is None)
        for k in evicted:
            assert a.peek(k) is None       # already unlinked
            mirror.pop(k)
        if blk is None:
            assert mirror == before        # failed translate evicts nothing
            assert heap.largest_attainable_run(
                {b.gpu_addr for b in (a.peek(k) for k in a.keys())
                 if b.reader == 0}) < nbytes
        else:
            assert blk.gpu_addr == ref_blk.gpu_addr
            mirror[key] = blk.nbytes
            if release:
                a.release(key)
                ref.release(rkey)
                pinned.discard(key)
            else:
                pinned.add(key)
        assert set(a.keys()) == set(mirror)
        assert heap.used == sum(mirror.values()) == ref_heap.used
        assert pinned <= set(a.keys())     # pinned blocks never evicted
        a.check_invariants()
        heap.check_invariants()


# ----------------------------------------------------------------- MESI-X
@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2),        # device
                          st.sampled_from(["fill", "evict", "write"])),
                min_size=1, max_size=60))
def test_mesix_states_always_consistent(events):
    d, ref = MesixDirectory(3, [[0, 1, 2]]), RefDirectory(3, [[0, 1, 2]])
    key, rkey = TileKey("C", 1, 1), RefKey("C", 1, 1)
    holders = set()
    for dev, ev in events:
        if ev == "fill":
            d.on_fill(key, dev)
            ref.on_fill(rkey, dev)
            holders.add(dev)
        elif ev == "evict":
            d.on_evict(key, dev)
            ref.on_evict(rkey, dev)
            holders.discard(dev)
        else:
            assert sorted(d.on_write(key, dev)) == \
                sorted(ref.on_write(rkey, dev))
            holders.clear()          # ephemeral M -> I invalidates all
        d.check_invariants()
        want = "I" if not holders else ("E" if len(holders) == 1 else "S")
        assert d.state(key) == want == ref.state(rkey)


# ---------------------------------------------------------------- tiling
@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(1, 300), st.integers(1, 64))
def test_tile_grid_partitions_exactly(rows, cols, tile):
    g, ref = TileGrid("A", rows, cols, tile), RefGrid("A", rows, cols, tile)
    shapes = [g.tile_shape(i, j)
              for i in range(g.n_tile_rows) for j in range(g.n_tile_cols)]
    assert sum(h * w for h, w in shapes) == rows * cols
    assert shapes == [ref.tile_shape(i, j)
                      for i in range(ref.n_tile_rows)
                      for j in range(ref.n_tile_cols)]


@settings(max_examples=20, deadline=None)
@given(st.integers(32, 200), st.integers(32, 200), st.integers(32, 200),
       st.integers(16, 96))
def test_gemm_taskization_flops_exact(m, k, n, tile):
    def taskize(fn, grid):
        return fn(grid("A", m, k, tile), grid("B", k, n, tile),
                  grid("C", m, n, tile), "N", "N", 1.0, 0.0)

    tasks = taskize(taskize_gemm, TileGrid)
    assert total_flops(tasks) == 2 * m * k * n
    outs = [t.out for t in tasks]
    assert len(outs) == len(set(outs)) == TileGrid("C", m, n, tile).n_tiles
    ref = taskize(ref_taskize_gemm, RefGrid)
    assert [(t.task_id, t.i, t.j, len(t.steps), t.flops) for t in tasks] == \
        [(t.task_id, t.i, t.j, len(t.steps), t.flops) for t in ref]


# ------------------------------------------------------ end-to-end gemm
@settings(max_examples=10, deadline=None)
@given(st.integers(17, 120), st.integers(17, 120), st.integers(17, 120),
       st.integers(16, 64), st.integers(1, 3))
def test_gemm_random_shapes_match_oracle(m, k, n, tile, n_devices):
    """Any shape, tile and device count: the port's numpy backend gives
    the reference's result bit for bit, and the oracle's to 1e-10."""
    rng = np.random.default_rng(m * 7 + k * 3 + n)
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    out = gemm(A, B, tile=tile,
               config=RuntimeConfig(n_devices=n_devices, mode="sim",
                                    cache_bytes=8 << 20, backend="numpy",
                                    device="cpu"))
    np.testing.assert_allclose(out, A @ B, rtol=1e-10, atol=1e-10)
    want = ref_gemm(A, B, tile=tile,
                    config=RefConfig(n_devices=n_devices, mode="sim",
                                     cache_bytes=8 << 20))
    assert np.array_equal(out, want)
