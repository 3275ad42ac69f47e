"""ALRU — Approximate Least-Recently-Used tile cache (paper §IV-B, Alg. 2).

One ALRU per device implements that device's L1 tile cache over its
private RAM.  The vanilla LRU cannot be used because kernels are
asynchronous: the least-recent block may still be read by an in-flight
task.  Each block therefore carries a *reader* counter, atomically
incremented when a task acquires the tile and decremented at the next
stream-synchronization point (Alg. 1 line 17 ``ReaderUpdate``).
Eviction scans from the LRU end toward the front and discards the first
block with ``reader == 0`` — the *approximate* LRU victim.

The ALRU stores where the tile lives in the device heap
(``BlasxHeap`` offset = the paper's "GPU address").

Multi-tenant quotas (serving front end, ``repro.serve`` in the reference)
--------------------------------------------------------
Each block optionally carries an *owner* tag — the tenant whose
request pulled the tile in.  With per-owner byte quotas configured
(:meth:`Alru.set_quota`) the cache becomes partitioned under
pressure:

* an owner at its quota evicts from its **own** LRU blocks first
  (never inflating its footprint past the quota);
* while any quota is configured, cross-owner eviction is forbidden —
  a flooding tenant can only reclaim its own blocks and untagged
  (``owner=None``) ones, so another tenant's warm working set
  survives the flood (the serving isolation invariant);
* when neither self-eviction nor untagged eviction can make room,
  :meth:`translate` returns ``None`` and the caller degrades to an
  uncached read, exactly like the all-pinned case.

With no quotas configured behaviour is byte-for-byte the legacy ALRU.

Evictions are reported, not called back
---------------------------------------
Every operation that can evict (:meth:`Alru.translate`,
:meth:`Alru.set_quota`) returns the keys it evicted.  The caller syncs
the MESI-X directory and the device tile store *after* the ALRU lock
is released, so no foreign code ever runs under it.  In the window
between the two, a peer that reads a stale directory holder finds
either a still-valid payload (tiles are never rewritten in place) or
nothing, and the runtime's acquire path already answers "nothing"
with a host fetch.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from .heap import BlasxHeap
from .tiling import TileKey


@dataclasses.dataclass
class LRUBlock:
    """One cached tile: host address (tile key), device address (heap
    offset), byte size, reader count, owner tenant (None = untagged),
    intrusive list links."""

    host_addr: TileKey
    gpu_addr: int
    nbytes: int
    reader: int = 0
    owner: Optional[str] = None
    prev: Optional["LRUBlock"] = dataclasses.field(default=None, repr=False)
    next: Optional["LRUBlock"] = dataclasses.field(default=None, repr=False)


class Alru:
    # lock-discipline declarations (repro.analysis, docs/ANALYSIS.md):
    # every field below may only be touched under _lock; the listed
    # helpers are only ever called with _lock already held.
    _GUARDED_BY = {"_lock": (
        "_map", "_front", "_back", "hits", "misses", "evictions",
        "lifetime_hits", "lifetime_misses", "lifetime_evictions",
        "_quota", "_owner_bytes", "quota_evictions",
        "quota_evictions_by_owner")}
    _LOCK_HELD = ("_dequeue", "_enqueue", "_push_front", "_unlink",
                  "_may_evict", "_drop_owner_bytes")

    def __init__(self, device_id: int, heap: BlasxHeap):
        self.device_id = device_id
        self.heap = heap
        self._map: Dict[TileKey, LRUBlock] = {}
        self._front: Optional[LRUBlock] = None  # most recently used
        self._back: Optional[LRUBlock] = None   # least recently used
        self._lock = threading.RLock()
        # instrumentation — cumulative across every run of a session
        # (a persistent context reuses one ALRU for many calls); the
        # lifetime_* counters survive reset_stats() so cross-call
        # eviction pressure stays observable.
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.lifetime_hits = 0
        self.lifetime_misses = 0
        self.lifetime_evictions = 0
        # multi-tenant quota state: per-owner byte quotas, resident
        # bytes per owner, and evictions performed to keep an owner
        # under its own quota (the serving layer's "cache-quota
        # evictions" stat; cumulative, reset_stats leaves it alone
        # like the lifetime counters)
        self._quota: Dict[str, int] = {}
        self._owner_bytes: Dict[str, int] = {}
        self.quota_evictions = 0
        self.quota_evictions_by_owner: Dict[str, int] = {}

    # ------------------------------------------------------------- queries
    def __contains__(self, key: TileKey) -> bool:
        with self._lock:
            return key in self._map

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def peek(self, key: TileKey) -> Optional[LRUBlock]:
        with self._lock:
            return self._map.get(key)

    def keys(self):
        with self._lock:
            return list(self._map.keys())

    # ------------------------------------------------------ tenant quotas
    def set_quota(self, owner: str, nbytes: Optional[int]) -> List[TileKey]:
        """Cap ``owner``'s resident bytes at ``nbytes`` (None removes
        the cap).  The moment any quota exists, cross-owner eviction is
        disabled on this cache (see module docstring).  Returns the
        keys evicted to get under the new cap."""
        evicted: List[TileKey] = []
        with self._lock:
            if nbytes is None:
                self._quota.pop(owner, None)
                return evicted
            self._quota[owner] = int(nbytes)
            # a cap below current residency applies now: trim the
            # owner's zero-reader LRU blocks down to it (pinned blocks
            # ride out their readers and are reclaimed by the next
            # over-quota miss)
            while self._owner_bytes.get(owner, 0) > int(nbytes):
                victim = self._dequeue(owner=owner, restrict=owner,
                                       quota_evict=True)
                if victim is None:
                    break
                evicted.append(victim.host_addr)
        return evicted

    def quota_of(self, owner: Optional[str]) -> Optional[int]:
        with self._lock:
            return self._quota.get(owner) if owner is not None else None

    @property
    def quotas_enabled(self) -> bool:
        with self._lock:
            return bool(self._quota)

    def owner_bytes(self, owner: Optional[str]) -> int:
        """Resident cached bytes currently tagged with ``owner``."""
        with self._lock:
            return self._owner_bytes.get(owner, 0)

    def _may_evict(self, block: LRUBlock, owner: Optional[str]) -> bool:
        """Eviction permission under quotas: with any quota configured
        a requester may only reclaim its own blocks or untagged ones;
        without quotas (legacy) everything zero-reader is fair game."""
        if not self._quota:
            return True
        return block.owner is None or block.owner == owner

    # ----------------------------------------------------------- Alg.2 ops
    def translate(self, key: TileKey, nbytes: int,
                  owner: Optional[str] = None
                  ) -> Tuple[Optional[LRUBlock], List[TileKey]]:
        """Alg. 2 ``Translate``: host address -> ``(cached block,
        evicted keys)``.

        On a hit the block moves to the front (recency) and is returned.
        On a miss a new block is allocated (evicting zero-reader LRU
        blocks as needed) and returned with ``fresh`` semantics: the
        caller must fill it (i.e. perform the H2D/P2P transfer) and the
        block's reader is already incremented for the requesting task.
        The block is None — with *no* blocks evicted — when the cache can
        never make room: every block is pinned by readers, the pinned
        blocks fragment the heap so badly that no sequence of
        evictions yields ``nbytes`` contiguous, or (quota mode) the
        requesting ``owner`` is at its byte quota with nothing of its
        own evictable.  The caller degrades to an uncached read (or
        synchronizes streams) and retries.

        ``owner`` tags the block with the tenant whose request pulled
        it in; eviction permissions under quotas key off it (see
        module docstring).  A cache hit never re-tags: the first
        owner keeps the block (shared tiles stay attributed to whoever
        paid the transfer).

        The evicted keys are for the caller to drop from the directory
        and the tile store once this call has returned (see module
        docstring); a failed translate may still report quota
        self-evictions made before it gave up.
        """
        evicted: List[TileKey] = []
        with self._lock:
            block = self._map.get(key)
            if block is not None:  # cache hit
                self.hits += 1
                self.lifetime_hits += 1
                self._unlink(block)
                self._push_front(block)
                block.reader += 1
                return block, evicted
            # miss: allocate, evicting as needed
            self.misses += 1
            self.lifetime_misses += 1
            quota = self._quota.get(owner) if owner is not None else None
            if quota is not None:
                if nbytes > quota:
                    return None, evicted  # can never fit under the cap
                # stay under the cap by reclaiming the owner's own LRU
                # blocks; other tenants' blocks are never touched here
                while self._owner_bytes.get(owner, 0) + nbytes > quota:
                    victim = self._dequeue(owner=owner, restrict=owner,
                                           quota_evict=True)
                    if victim is None:
                        return None, evicted  # own blocks all pinned
                    evicted.append(victim.host_addr)
            gpu_addr = self.heap.malloc(nbytes)
            if gpu_addr is None:
                # over-eviction guard: on a fragmented heap with mixed
                # tile sizes, evicting zero-reader blocks one-by-one
                # could wipe the whole cache and *still* fail (pinned
                # blocks fence the free runs).  Prove attainability
                # first — counting only blocks this owner is *allowed*
                # to evict — and if no amount of permitted eviction can
                # make room, fail without touching a single resident
                # block.
                evictable = {b.gpu_addr for b in self._map.values()
                             if b.reader == 0 and self._may_evict(b, owner)}
                if self.heap.largest_attainable_run(evictable) < nbytes:
                    return None, evicted  # caller reads uncached
            while gpu_addr is None:
                victim = self._dequeue(owner=owner)
                if victim is None:  # pragma: no cover - guarded above
                    return None, evicted  # everything pinned
                evicted.append(victim.host_addr)
                gpu_addr = self.heap.malloc(nbytes)
            block = self._enqueue(key, gpu_addr, nbytes, owner)
            block.reader = 1
            block.fresh = True  # type: ignore[attr-defined]
            return block, evicted

    def release(self, key: TileKey) -> None:
        """Reader decrement at a synchronization point (Alg. 1 line 17)."""
        with self._lock:
            block = self._map.get(key)
            if block is None:
                return  # already evicted after its readers hit zero
            if block.reader <= 0:
                raise RuntimeError(f"release underflow on {key}")
            block.reader -= 1

    def invalidate(self, key: TileKey) -> bool:
        """MESI-X I transition: drop the tile if present (regardless of
        recency).  Refuses while readers are active."""
        with self._lock:
            block = self._map.get(key)
            if block is None:
                return False
            if block.reader > 0:
                raise RuntimeError(f"invalidate of in-use tile {key}")
            self._unlink(block)
            del self._map[key]
            self._drop_owner_bytes(block)
            self.heap.free(block.gpu_addr)
            return True

    def reset_stats(self) -> None:
        """Zero the per-session counters at a call/session boundary
        without touching resident blocks; lifetime_* keep counting."""
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    # ---------------------------------------------------------- internals
    def _drop_owner_bytes(self, block: LRUBlock) -> None:
        """Deduct a departing block from its owner's residency count."""
        if block.owner is None:
            return
        left = self._owner_bytes.get(block.owner, 0) - block.nbytes
        if left > 0:
            self._owner_bytes[block.owner] = left
        else:
            self._owner_bytes.pop(block.owner, None)

    def _dequeue(self, owner: Optional[str] = None,
                 restrict: Optional[str] = None,
                 quota_evict: bool = False) -> Optional[LRUBlock]:
        """Alg. 2 ``Dequeue``: walk from the LRU end toward the front,
        evict the first block with zero readers and release its heap
        bytes.  The caller reports the victim's key to its own caller,
        which syncs the directory after the heap bytes are free.

        ``owner`` applies the quota-mode eviction permission filter
        (:meth:`_may_evict`); ``restrict`` narrows further to blocks
        of exactly that owner (quota self-eviction).  ``quota_evict``
        charges the eviction to the quota counters instead of the
        capacity ones — the serving stats distinguish "evicted to make
        room" from "evicted to stay under the tenant cap"."""
        block = self._back
        while block is not None:
            if block.reader == 0 and self._may_evict(block, owner) and \
                    (restrict is None or block.owner == restrict):
                self._unlink(block)
                del self._map[block.host_addr]
                self._drop_owner_bytes(block)
                self.heap.free(block.gpu_addr)
                self.evictions += 1
                self.lifetime_evictions += 1
                if quota_evict:
                    self.quota_evictions += 1
                    if block.owner is not None:
                        self.quota_evictions_by_owner[block.owner] = \
                            self.quota_evictions_by_owner.get(
                                block.owner, 0) + 1
                return block
            block = block.prev
        return None

    def _enqueue(self, key: TileKey, gpu_addr: int, nbytes: int,
                 owner: Optional[str] = None) -> LRUBlock:
        """Alg. 2 ``Enqueue``: new block at the front."""
        block = LRUBlock(host_addr=key, gpu_addr=gpu_addr, nbytes=nbytes,
                         owner=owner)
        self._map[key] = block
        if owner is not None:
            self._owner_bytes[owner] = \
                self._owner_bytes.get(owner, 0) + nbytes
        self._push_front(block)
        return block

    def _push_front(self, block: LRUBlock) -> None:
        block.prev = None
        block.next = self._front
        if self._front is not None:
            self._front.prev = block
        self._front = block
        if self._back is None:
            self._back = block

    def _unlink(self, block: LRUBlock) -> None:
        if block.prev is not None:
            block.prev.next = block.next
        else:
            self._front = block.next
        if block.next is not None:
            block.next.prev = block.prev
        else:
            self._back = block.prev
        block.prev = block.next = None

    # ------------------------------------------------------------ checking
    def check_invariants(self) -> None:
        with self._lock:
            seen = set()
            block = self._front
            prev = None
            while block is not None:
                if block.host_addr in seen:
                    raise RuntimeError("cycle / duplicate in ALRU list")
                seen.add(block.host_addr)
                if block.prev is not prev:
                    raise RuntimeError("broken prev link")
                if self._map.get(block.host_addr) is not block:
                    raise RuntimeError("map out of sync with list")
                prev = block
                block = block.next
            if self._back is not prev:
                raise RuntimeError("broken back pointer")
            if len(seen) != len(self._map):
                raise RuntimeError("list/map size mismatch")
            # quota bookkeeping: _owner_bytes must equal the per-owner
            # sums over resident blocks (both ways: no stale owners),
            # and no quota'd owner may sit above its cap
            by_owner: Dict[str, int] = {}
            for b in self._map.values():
                if b.owner is not None:
                    by_owner[b.owner] = by_owner.get(b.owner, 0) + b.nbytes
            if by_owner != self._owner_bytes:
                raise RuntimeError(
                    f"owner byte ledger out of sync: walked {by_owner} "
                    f"!= tracked {self._owner_bytes}")
            for owner, cap in self._quota.items():
                resident = by_owner.get(owner, 0)
                if resident > cap:
                    # enforcement can only reclaim zero-reader blocks,
                    # so residency above a (freshly lowered) cap is
                    # legal exactly while every one of the owner's
                    # blocks is pinned by in-flight readers
                    pinned = sum(b.nbytes for b in self._map.values()
                                 if b.owner == owner and b.reader > 0)
                    if pinned < resident:
                        raise RuntimeError(
                            f"owner {owner!r} resident {resident} bytes "
                            f"exceeds quota {cap} with evictable blocks")
