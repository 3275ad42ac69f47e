"""BLASX_Malloc: fast heap to amortize device alloc/dealloc (paper §IV-E, Fig. 6).

The paper pre-allocates one big chunk of GPU memory and manages it with
three structures: a meta-data list (segment length + occupancy), an
occupied list (hashtable address -> node for O(1) free) and an empty
list (free segments, first-fit).  Freeing coalesces with contiguous
neighbors.  We reproduce exactly that: a first-fit free-list allocator
with neighbor coalescing over a byte arena, plus counters so benchmarks
can contrast it against a "cudaMalloc"-style slow path (Fig. 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class _Segment:
    """Node of the meta-data list (Fig. 6): one contiguous byte range."""

    offset: int
    length: int
    occupied: bool
    prev: Optional["_Segment"] = dataclasses.field(default=None, repr=False)
    next: Optional["_Segment"] = dataclasses.field(default=None, repr=False)


class HeapError(Exception):
    pass


class BlasxHeap:
    """First-fit arena allocator with coalescing (BLASX_Malloc)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("heap capacity must be positive")
        self.capacity = capacity
        head = _Segment(offset=0, length=capacity, occupied=False)
        self._head = head
        # occupied list: offset -> segment, the paper's hashtable for O(1) free
        self._occupied: Dict[int, _Segment] = {}
        # instrumentation
        self.n_alloc = 0
        self.n_free = 0
        self.n_split = 0
        self.n_coalesce = 0
        self.peak_used = 0
        self._used = 0

    # ------------------------------------------------------------------ api
    @property
    def used(self) -> int:
        return self._used

    @property
    def free_bytes(self) -> int:
        return self.capacity - self._used

    def malloc(self, size: int) -> Optional[int]:
        """First-fit allocation.  Returns byte offset or None when no
        segment is large enough (caller evicts via the ALRU and retries)."""
        if size <= 0:
            raise ValueError("malloc size must be positive")
        seg = self._head
        while seg is not None:
            if not seg.occupied and seg.length >= size:
                if seg.length > size:  # split: occupied node + residual free node
                    rest = _Segment(
                        offset=seg.offset + size,
                        length=seg.length - size,
                        occupied=False,
                        prev=seg,
                        next=seg.next,
                    )
                    if seg.next is not None:
                        seg.next.prev = rest
                    seg.next = rest
                    seg.length = size
                    self.n_split += 1
                seg.occupied = True
                self._occupied[seg.offset] = seg
                self.n_alloc += 1
                self._used += size
                self.peak_used = max(self.peak_used, self._used)
                return seg.offset
            seg = seg.next
        return None

    def free(self, offset: int) -> None:
        """O(1) lookup via the occupied hashtable, then coalesce with
        contiguous free neighbors (paper Fig. 6)."""
        seg = self._occupied.pop(offset, None)
        if seg is None:
            raise HeapError(f"free of unallocated offset {offset}")
        seg.occupied = False
        self.n_free += 1
        self._used -= seg.length
        # merge with next
        nxt = seg.next
        if nxt is not None and not nxt.occupied:
            seg.length += nxt.length
            seg.next = nxt.next
            if nxt.next is not None:
                nxt.next.prev = seg
            self.n_coalesce += 1
        # merge with prev
        prv = seg.prev
        if prv is not None and not prv.occupied:
            prv.length += seg.length
            prv.next = seg.next
            if seg.next is not None:
                seg.next.prev = prv
            self.n_coalesce += 1

    def largest_free_run(self) -> int:
        """Length of the largest currently-free contiguous segment."""
        return self.largest_attainable_run(())

    def largest_attainable_run(self, freeable_offsets) -> int:
        """Largest contiguous run reachable by freeing (any subset of)
        the occupied segments at ``freeable_offsets``.  Occupied
        segments *not* in the set are barriers (e.g. cache blocks
        pinned by in-flight readers).  Lets the ALRU prove that no
        amount of eviction can satisfy an allocation before it starts
        evicting (over-eviction guard)."""
        freeable = set(freeable_offsets)
        best = run = 0
        seg = self._head
        while seg is not None:
            if not seg.occupied or seg.offset in freeable:
                run += seg.length
                best = max(best, run)
            else:
                run = 0
            seg = seg.next
        return best

    # -------------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Used by property tests: segments tile the arena exactly, no two
        adjacent free segments, occupied table consistent."""
        seg = self._head
        offset = 0
        used = 0
        prev_free = False
        walked_occ = set()
        while seg is not None:
            if seg.offset != offset:
                raise HeapError(f"segment offset {seg.offset} != expected {offset}")
            if seg.length <= 0:
                raise HeapError("non-positive segment length")
            if seg.occupied:
                if self._occupied.get(seg.offset) is not seg:
                    raise HeapError("occupied table out of sync")
                walked_occ.add(seg.offset)
                used += seg.length
                prev_free = False
            else:
                if prev_free:
                    raise HeapError("two adjacent free segments (missed coalesce)")
                prev_free = True
            offset += seg.length
            seg = seg.next
        if offset != self.capacity:
            raise HeapError(f"segments cover {offset} != capacity {self.capacity}")
        if used != self._used:
            raise HeapError(f"used accounting {self._used} != actual {used}")
        # the table must hold exactly the occupied segments the walk saw:
        # the per-segment identity check above catches missing/aliased
        # entries, but only a cross-check against the walked set catches
        # stale entries for segments no longer (or never) in the list
        stale = set(self._occupied) - walked_occ
        if stale:
            raise HeapError(
                f"occupied table has {len(stale)} stale entr"
                f"{'y' if len(stale) == 1 else 'ies'} not backed by any "
                f"occupied segment: offsets {sorted(stale)[:8]}")
