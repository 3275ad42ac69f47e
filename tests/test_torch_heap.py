"""Twins of ``test_heap.py`` for the port's ``core/heap.py``
(BLASX_Malloc, paper §IV-E, Fig. 6).

``check_invariants`` walks the meta-data list and cross-checks the
walked occupied segments against the occupied table in both
directions: the four corruption regressions hold that each direction
fires, and the seeded random traces hold the invariants, the
largest-attainable-run query against a brute-force walk, and every
offset against the reference's heap driven by the same trace.
"""
import random

import pytest

from repro.core.heap import BlasxHeap as RefHeap
from repro_torch.core.heap import BlasxHeap, HeapError, _Segment


# ------------------------------------------------- corruption regressions
def test_stale_occupied_entry_is_detected():
    """An extra table entry with no backing occupied segment fails."""
    h = BlasxHeap(1024)
    off = h.malloc(100)
    assert off is not None
    h.check_invariants()
    h._occupied[999] = _Segment(offset=999, length=1, occupied=True)
    with pytest.raises(HeapError, match="stale"):
        h.check_invariants()


def test_stale_entry_for_freed_segment_is_detected():
    """A freed offset lingering in the table (a broken free()) fails."""
    h = BlasxHeap(1024)
    a = h.malloc(128)
    b = h.malloc(128)
    seg = h._occupied[a]
    h.free(a)
    h.check_invariants()
    h._occupied[a] = seg          # resurrect the popped entry
    seg.occupied = False          # ...but the segment itself is free
    with pytest.raises(HeapError, match="stale"):
        h.check_invariants()
    del h._occupied[a]
    h.free(b)
    h.check_invariants()


def test_missing_occupied_entry_is_detected():
    """An occupied segment absent from the table fails."""
    h = BlasxHeap(1024)
    off = h.malloc(64)
    del h._occupied[off]
    with pytest.raises(HeapError, match="out of sync"):
        h.check_invariants()


def test_aliased_occupied_entry_is_detected():
    """A table entry pointing at the wrong segment object fails."""
    h = BlasxHeap(1024)
    a = h.malloc(64)
    h.malloc(64)
    h._occupied[a] = _Segment(offset=a, length=64, occupied=True)
    with pytest.raises(HeapError, match="out of sync"):
        h.check_invariants()


# ------------------------------------------------ random property traces
def _brute_largest_attainable(h: BlasxHeap, freeable) -> int:
    """Oracle: longest run of segments that are free or freeable."""
    freeable = set(freeable)
    runs = []
    run = 0
    seg = h._head
    while seg is not None:
        if not seg.occupied or seg.offset in freeable:
            run += seg.length
        else:
            runs.append(run)
            run = 0
        seg = seg.next
    runs.append(run)
    return max(runs)


@pytest.mark.parametrize("seed", range(8))
def test_heap_invariants_under_random_traces(seed):
    """Random malloc/free/largest_attainable_run sequences: after every
    op the invariants hold, the query agrees with a brute-force walk and
    with the reference's heap, every offset is the reference's, and a
    full teardown returns the arena."""
    rng = random.Random(seed)
    h, ref = BlasxHeap(4096), RefHeap(4096)
    live = []
    for _ in range(300):
        op = rng.random()
        if op < 0.55 or not live:
            size = rng.randint(1, 400)
            off = h.malloc(size)
            assert off == ref.malloc(size)
            if off is not None:
                live.append(off)
        elif op < 0.9:
            off = live.pop(rng.randrange(len(live)))
            h.free(off)
            ref.free(off)
        else:
            subset = [o for o in live if rng.random() < 0.5]
            got = h.largest_attainable_run(subset)
            assert got == _brute_largest_attainable(h, subset)
            assert got == ref.largest_attainable_run(subset)
            assert got >= h.largest_free_run()
        h.check_invariants()
        assert set(h._occupied) == set(live)
    for off in live:
        h.free(off)
    h.check_invariants()
    assert h.free_bytes == 4096
    assert h.largest_free_run() == 4096


@pytest.mark.parametrize("seed", [11, 13])
def test_random_trace_then_corruption_always_caught(seed):
    """After an arbitrary trace, a stale table entry is always caught:
    the invariant is load-bearing, not vacuous."""
    rng = random.Random(seed)
    h = BlasxHeap(2048)
    live = []
    for _ in range(80):
        if rng.random() < 0.6 or not live:
            off = h.malloc(rng.randint(1, 300))
            if off is not None:
                live.append(off)
        else:
            h.free(live.pop(rng.randrange(len(live))))
    h.check_invariants()
    h._occupied[h.capacity + 1] = _Segment(
        offset=h.capacity + 1, length=5, occupied=True)
    with pytest.raises(HeapError, match="stale"):
        h.check_invariants()
