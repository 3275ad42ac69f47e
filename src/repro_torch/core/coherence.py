"""MESI-X cache-coherence protocol for the two-level tile cache
(paper §IV-B, Fig. 3).

States are *derived* from the set of ALRUs tracking a tile:

  E (exclusive) — exactly one device's ALRU holds the tile
  S (shared)    — more than one device's ALRU holds it
  I (invalid)   — no ALRU holds it (tile lives only in host RAM)
  M (modified)  — ephemeral: a device wrote a C_ij tile; it is written
                  back to host RAM immediately and transitions to I.

The directory maps each tile key to its holder set; it also answers
L2-cache queries: "which *peer* device (same P2P group) holds this
tile?".  All mutations are lock-guarded — the paper's runtime does the
same with atomics.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set

from .tiling import TileKey

STATE_E = "E"
STATE_S = "S"
STATE_I = "I"
STATE_M = "M"  # ephemeral; never observable at rest


class MesixDirectory:
    # lock-discipline declarations (repro.analysis, docs/ANALYSIS.md).
    # _group_of is immutable after __init__ and deliberately unlisted.
    _GUARDED_BY = {"_lock": (
        "_holders", "_served", "_serve_tick", "writebacks",
        "invalidations")}

    def __init__(self, n_devices: int, p2p_groups: Sequence[Sequence[int]]):
        """``p2p_groups`` — lists of device ids sharing a PCI-E switch /
        ICI neighborhood; L2 hits are only served within a group."""
        self.n_devices = n_devices
        self._holders: Dict[TileKey, Set[int]] = {}
        self._lock = threading.RLock()
        self._group_of: Dict[int, int] = {}
        for gid, group in enumerate(p2p_groups):
            for dev in group:
                self._group_of[dev] = gid
        for dev in range(n_devices):
            self._group_of.setdefault(dev, -1 - dev)  # isolated device
        # least-recently-served order for L2 peer selection: device ->
        # monotonic tick of its last P2P serve (absent = never served)
        self._served: Dict[int, int] = {}
        self._serve_tick = 0
        # instrumentation
        self.writebacks = 0
        self.invalidations = 0

    # ------------------------------------------------------------- queries
    def state(self, key: TileKey) -> str:
        with self._lock:
            holders = self._holders.get(key)
            if not holders:
                return STATE_I
            return STATE_E if len(holders) == 1 else STATE_S

    def holders(self, key: TileKey) -> Set[int]:
        with self._lock:
            return set(self._holders.get(key, ()))

    def peer_holder(self, key: TileKey, device_id: int) -> Optional[int]:
        """L2 tile-cache lookup: a device in the *same* P2P group holding
        the tile (excluding the requester), or None (=> fetch from host).

        Among multiple eligible holders the *least-recently-served* one
        is chosen (ties break toward the lowest id, so the pick stays
        deterministic).  Always answering the lowest id — the old
        behaviour — funnelled every L2 hit through one device and
        drained its D2D egress lane while its peers' lanes sat idle
        (skewed ``d2d_served_s``/``d2d_busy_s`` in the event-engine
        ledger).  The query itself is read-only; the runtime reports an
        actual P2P fetch via :meth:`mark_served`, which is what rotates
        the order."""
        gid = self._group_of[device_id]
        with self._lock:
            eligible = [dev for dev in self._holders.get(key, ())
                        if dev != device_id and self._group_of[dev] == gid]
            if not eligible:
                return None
            return min(eligible,
                       key=lambda dev: (self._served.get(dev, -1), dev))

    def mark_served(self, device_id: int) -> None:
        """Record that ``device_id`` just served a P2P fetch, moving it
        to the back of the least-recently-served order."""
        with self._lock:
            self._serve_tick += 1
            self._served[device_id] = self._serve_tick

    def same_group(self, a: int, b: int) -> bool:
        return self._group_of[a] == self._group_of[b]

    # ----------------------------------------------------------- mutations
    def on_fill(self, key: TileKey, device_id: int) -> str:
        """A device cached the tile (I->E, E->S, S->S)."""
        with self._lock:
            holders = self._holders.setdefault(key, set())
            holders.add(device_id)
            return STATE_E if len(holders) == 1 else STATE_S

    def on_evict(self, key: TileKey, device_id: int) -> str:
        """A device's ALRU dropped the tile (S->S/E, E->I)."""
        with self._lock:
            holders = self._holders.get(key)
            if holders is not None:
                holders.discard(device_id)
                if not holders:
                    del self._holders[key]
            return self.state(key)

    def on_write(self, key: TileKey, device_id: int) -> List[int]:
        """MESI-X write: a device produced a C_ij tile.  The M state is
        ephemeral — the caller writes the tile back to host RAM and we
        invalidate *all* cached copies (including the writer's), i.e.
        M -> I immediately (Fig. 3).  Returns the list of devices whose
        copies were invalidated, so the runtime can purge their ALRUs."""
        with self._lock:
            holders = sorted(self._holders.pop(key, ()))
            self.writebacks += 1
            self.invalidations += len(holders)
            return holders

    # ------------------------------------------------------------ checking
    def check_invariants(self) -> None:
        with self._lock:
            for key, holders in self._holders.items():
                if not holders:
                    raise RuntimeError(f"empty holder set kept for {key}")
                for dev in holders:
                    if not (0 <= dev < self.n_devices):
                        raise RuntimeError(f"bogus device {dev} holds {key}")

    def audit(self, alrus: Sequence) -> None:
        """Cross-check the directory against the actual caches: every
        holder entry must correspond to a resident block in that
        device's ALRU, and every resident block must be registered
        here.  The quota machinery evicts through the same
        ``on_evict`` path as capacity pressure, so tenant isolation
        must leave this bijection intact.

        The ALRU queries run *outside* the directory lock, against a
        snapshot of the holder map, so this lock is never held while a
        cache lock is taken.  Callers run this under quiescence (the
        bijection is only meaningful with no eviction between an ALRU
        dropping a block and the runtime reporting it here), so the
        snapshot loses nothing."""
        with self._lock:
            snapshot = {key: sorted(holders)
                        for key, holders in self._holders.items()}
        for key, holders in snapshot.items():
            for dev in holders:
                if not (0 <= dev < len(alrus)):
                    raise RuntimeError(f"bogus device {dev} holds {key}")
                if key not in alrus[dev]:
                    raise RuntimeError(
                        f"directory says device {dev} holds {key} "
                        "but its ALRU has no such block")
        for dev, alru in enumerate(alrus):
            for key in alru.keys():
                if dev not in snapshot.get(key, ()):
                    raise RuntimeError(
                        f"device {dev} caches {key} but the "
                        "directory does not list it as a holder")
