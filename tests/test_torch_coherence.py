"""The port's MESI-X directory against the reference's.

Twins of ``test_coherence.py``: derived E/S/I states, the ephemeral-M
write-back path, P2P group fencing and least-recently-served peer
rotation, and concurrent mutation safety.  Each scenario runs through
both directories, which must return the same states, holders and peers
step for step.
"""
import threading

import pytest

from repro.core.coherence import MesixDirectory as RefDirectory
from repro.core.tiling import TileKey as RefKey
from repro_torch.core.coherence import MesixDirectory
from repro_torch.core.tiling import TileKey


class _Both:
    """Drive the port's and the reference's directory in lockstep: every
    call returns the port's answer after checking it is the
    reference's."""

    def __init__(self, *args):
        self.port, self.ref = MesixDirectory(*args), RefDirectory(*args)

    def __getattr__(self, name):
        def call(*args):
            ref_args = [RefKey(a.matrix_id, a.i, a.j)
                        if isinstance(a, TileKey) else a for a in args]
            got = getattr(self.port, name)(*args)
            want = getattr(self.ref, name)(*ref_args)
            assert got == want, (name, args, got, want)
            return got
        return call


def _key(i, j=0, mat="A"):
    return TileKey(mat, i, j)


# ---------------------------------------------------- derived transitions
def test_states_are_derived_from_holder_sets():
    d = _Both(4, [[0, 1, 2, 3]])
    k = _key(0)
    assert d.state(k) == "I" and d.holders(k) == set()
    assert d.on_fill(k, 2) == "E"
    assert d.state(k) == "E" and d.holders(k) == {2}
    assert d.on_fill(k, 0) == "S"
    assert d.on_fill(k, 3) == "S"
    assert d.holders(k) == {0, 2, 3}
    assert d.on_fill(k, 2) == "S"      # idempotent refill
    assert d.holders(k) == {0, 2, 3}
    assert d.on_evict(k, 0) == "S"
    assert d.on_evict(k, 3) == "E"
    assert d.on_evict(k, 2) == "I"
    assert d.holders(k) == set()
    d.port.check_invariants()


def test_evict_of_non_holder_is_harmless():
    d = _Both(2, [[0, 1]])
    k = _key(1)
    assert d.on_evict(k, 0) == "I"     # never filled
    d.on_fill(k, 0)
    assert d.on_evict(k, 1) == "E"     # device 1 never held it
    assert d.holders(k) == {0}
    d.port.check_invariants()


# ------------------------------------------------------- ephemeral M path
def test_write_invalidates_every_copy_including_writer():
    d = _Both(3, [[0, 1, 2]])
    k = _key(0, mat="C")
    for dev in range(3):
        d.on_fill(k, dev)
    assert d.on_write(k, 1) == [0, 1, 2]   # writer included, sorted
    assert d.state(k) == "I"
    assert d.holders(k) == set()
    assert d.port.writebacks == d.ref.writebacks == 1
    assert d.port.invalidations == d.ref.invalidations == 3


def test_write_with_no_cached_copies_still_counts_writeback():
    d = _Both(2, [[0, 1]])
    k = _key(5, mat="C")
    assert d.on_write(k, 0) == []
    assert d.port.writebacks == 1 and d.port.invalidations == 0
    assert d.state(k) == "I"


def test_write_then_refill_restarts_at_exclusive():
    d = _Both(2, [[0, 1]])
    k = _key(2, mat="C")
    d.on_fill(k, 0)
    d.on_write(k, 0)
    assert d.on_fill(k, 1) == "E"
    assert d.holders(k) == {1}


# ------------------------------------------------------------ P2P fencing
def test_peer_holder_never_crosses_p2p_groups():
    groups = [[0, 1], [2, 3]]
    group_of = {0: 0, 1: 0, 2: 1, 3: 1}
    k = _key(7)
    for holder in range(5):
        d = _Both(5, groups)            # device 4 isolated (no group)
        d.on_fill(k, holder)
        for requester in range(5):
            peer = d.peer_holder(k, requester)
            if peer is not None:
                assert peer == holder
                assert peer != requester
                assert group_of[peer] == group_of[requester]
            else:
                same = (requester != holder
                        and group_of.get(requester) is not None
                        and group_of.get(requester) == group_of.get(holder))
                assert not same, (requester, holder)
    d = _Both(5, groups)
    d.on_fill(k, 4)
    assert all(d.peer_holder(k, r) is None for r in range(5))


def test_peer_holder_rotates_least_recently_served():
    d = _Both(4, [[0, 1, 2, 3]])
    k = _key(3)
    d.on_fill(k, 3)
    d.on_fill(k, 1)
    assert d.peer_holder(k, 0) == 1    # never served: lowest id wins
    assert d.peer_holder(k, 0) == 1    # pure query: no rotation
    assert d.peer_holder(k, 1) == 3    # self excluded
    d.mark_served(1)
    assert d.peer_holder(k, 0) == 3
    d.mark_served(3)
    assert d.peer_holder(k, 0) == 1


def test_peer_holder_serves_spread_evenly_across_holders():
    d = _Both(4, [[0, 1, 2, 3]])
    k = _key(0)
    for holder in (0, 1, 2):
        d.on_fill(k, holder)
    served = {0: 0, 1: 0, 2: 0}
    for _ in range(9):
        peer = d.peer_holder(k, 3)
        served[peer] += 1
        d.mark_served(peer)
    assert served == {0: 3, 1: 3, 2: 3}


# ------------------------------------------------------------ concurrency
@pytest.mark.parametrize("seed_offset", [0, 1])
def test_concurrent_register_and_invalidate(seed_offset):
    """Two threads hammer overlapping keys with fill/evict/write on the
    port's directory; it stays internally consistent and every key
    settles in a derived state."""
    d = MesixDirectory(2, [[0, 1]])
    keys = [_key(i % 8, i // 8) for i in range(32)]
    errors = []
    barrier = threading.Barrier(2)

    def worker(dev):
        try:
            barrier.wait()
            for rep in range(200):
                k = keys[(rep * (dev + 1) + seed_offset) % len(keys)]
                d.on_fill(k, dev)
                if rep % 3 == 0:
                    d.on_evict(k, dev)
                if rep % 7 == 0:
                    d.on_write(k, dev)
                d.peer_holder(k, dev)
        except BaseException as e:  # surfaced after join
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(dev,))
               for dev in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    d.check_invariants()
    for k in keys:
        holders = d.holders(k)
        assert d.state(k) == {0: "I", 1: "E"}.get(len(holders), "S")
        assert holders <= {0, 1}
    for k in keys:
        for dev in range(2):
            d.on_evict(k, dev)
        assert d.state(k) == "I"
    d.check_invariants()
