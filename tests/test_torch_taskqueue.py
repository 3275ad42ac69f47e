"""The port's ready queue and reservation stations against the
reference's.

Twins of ``test_taskqueue.py``: the ``dequeue_wait`` spurious-wakeup
contract, crash-recovery requeue exactly once, dependency-gated enqueue,
and the steal-time priority refresh (Eq. 3 against current cache
state).  Where the order of delivery is the point, the reference's
queue runs the same tasks beside the port's and must deliver the same
ids.
"""
import threading
import time

import pytest

from repro.core.task import Task as RefTask
from repro.core.taskqueue import ReadyQueue as RefQueue
from repro.core.tiling import TileKey as RefKey
from repro_torch.core.alru import Alru
from repro_torch.core.heap import BlasxHeap
from repro_torch.core.task import Step, Task, TileRef
from repro_torch.core.taskqueue import ReadyQueue, ReservationStation
from repro_torch.core.tiling import TileKey


def _task(tid, deps=(), task=Task, key=TileKey):
    return task(task_id=tid, routine="gemm", out=key("C", tid, 0),
                i=tid, j=0, steps=(), alpha=1.0, beta=0.0,
                deps=tuple(deps))


def _ref_task(tid, deps=()):
    return _task(tid, deps, RefTask, RefKey)


# -------------------------------------------------- spurious-wakeup contract
def test_dequeue_wait_none_with_outstanding_means_retry():
    a, b = _task(0), _task(1, deps=[0])
    q = ReadyQueue([a, b])
    assert q.try_dequeue() is a
    assert q.dequeue_wait(timeout=0.01) is None   # b is dep-blocked...
    assert not q.drained()                        # ...which is no drain
    assert q.pending_count() == 1
    q.complete(a)
    assert q.dequeue_wait(timeout=0.01) is b
    q.complete(b)
    assert q.drained()
    assert q.dequeue_wait(timeout=0.01) is None


def test_dequeue_wait_wakes_on_cross_thread_completion():
    a, b = _task(0), _task(1, deps=[0])
    q = ReadyQueue([a, b])
    assert q.try_dequeue() is a
    result = []

    def consumer():
        while True:
            t = q.dequeue_wait(timeout=0.5)
            if t is not None:
                result.append(t)
                q.complete(t)
                return
            if q.drained():
                return

    th = threading.Thread(target=consumer)
    th.start()
    time.sleep(0.05)           # let the consumer park in dequeue_wait
    q.complete(a)              # releases b and notifies
    th.join(timeout=5)
    assert not th.is_alive()
    assert result == [b]
    assert q.drained()


# ----------------------------------------------------- crash-recovery requeue
def test_requeue_redelivers_exactly_once():
    a = _task(0)
    q = ReadyQueue([a])
    t = q.try_dequeue()
    assert t is a and not q.drained()
    q.requeue(t)
    assert q.has_ready()
    again = q.try_dequeue()
    assert again is a
    assert q.try_dequeue() is None
    assert not q.drained()
    q.complete(again)
    assert q.drained()


def test_requeue_rejects_foreign_tasks():
    q = ReadyQueue([_task(0)])
    with pytest.raises(ValueError, match="foreign"):
        q.requeue(_task(99))


def test_rs_drain_then_requeue_roundtrip():
    tasks = [_task(i) for i in range(4)]
    q = ReadyQueue(tasks)
    rs = ReservationStation(0, 4)
    for _ in range(3):
        rs.put(q.try_dequeue(), 0.0)
    assert len(rs) == 3
    drained = rs.drain()
    assert len(drained) == 3 and len(rs) == 0
    for t in drained:
        q.requeue(t)
    seen = set()
    while True:
        t = q.try_dequeue()
        if t is None:
            break
        seen.add(t.task_id)
        q.complete(t)
    assert seen == {0, 1, 2, 3}
    assert q.drained()


# ------------------------------------------------- steal priority refresh
def _tile_task(tid, matrix_id):
    """A task whose single k-step reads two tiles of ``matrix_id``."""
    return Task(task_id=tid, routine="gemm", out=TileKey("C", tid, 0),
                i=tid, j=0,
                steps=(Step(TileRef(TileKey(matrix_id, 0, 0)),
                            TileRef(TileKey(matrix_id, 0, 1))),),
                alpha=1.0, beta=0.0)


def test_steal_refreshes_priorities_against_current_cache_state():
    """Put-time priorities were recorded while the victim's cache was
    cold; its L1 then fills with task B's tiles.  The refreshed steal
    hands the thief the genuinely coldest task A, not the L1-hot B."""
    victim_l1 = Alru(0, BlasxHeap(1 << 20))
    a, b = _tile_task(0, "X"), _tile_task(1, "Y")
    rs = ReservationStation(0, 4)
    rs.put(a, 0.0)
    rs.put(b, 0.0)
    for ref in b.input_refs():
        blk, evicted = victim_l1.translate(ref.key, 64)
        assert blk is not None and evicted == []
        victim_l1.release(ref.key)

    def eq3(t):  # +2 per L1-resident input tile (runtime._priority)
        return sum(2.0 for ref in t.input_refs() if ref.key in victim_l1)

    assert rs.steal(eq3) is a, "steal took the victim's L1-hot task"
    assert rs.take_top(1) == [b]


def test_steal_without_refresh_uses_stored_priorities():
    rs = ReservationStation(0, 4)
    hi, lo = _task(0), _task(1)
    rs.put(hi, 5.0)
    rs.put(lo, 1.0)
    assert rs.steal() is lo
    assert rs.steal() is hi
    assert rs.steal() is None


# ----------------------------------------------------- dependency gating
def test_dependent_enqueues_only_after_last_producer():
    a, b = _task(0), _task(1)
    c = _task(2, deps=[0, 1])
    q = ReadyQueue([a, b, c])
    ta, tb = q.try_dequeue(), q.try_dequeue()
    assert {ta.task_id, tb.task_id} == {0, 1}
    assert not q.has_ready() and q.pending_count() == 1
    q.complete(ta)
    assert not q.has_ready()
    assert q.pending_count() == 1
    q.complete(tb)
    assert q.has_ready() and q.pending_count() == 0
    tc = q.try_dequeue()
    assert tc is c
    q.complete(tc)
    assert q.drained()


def test_chain_releases_in_order():
    """A TRSM-style linear chain releases one task per completion, in
    the reference's order."""
    orders = []
    for make, queue in ((_task, ReadyQueue), (_ref_task, RefQueue)):
        q = queue([make(0)] + [make(i, deps=[i - 1]) for i in range(1, 5)])
        order = []
        while not q.drained():
            t = q.try_dequeue()
            assert t is not None, "chain stalled"
            assert not q.has_ready(), "chain released more than one task"
            order.append(t.task_id)
            q.complete(t)
        orders.append(order)
    assert orders[0] == orders[1] == [0, 1, 2, 3, 4]


def test_complete_foreign_task_resolves_edges_only():
    producer = _task(0)                # lives in ANOTHER device's queue
    dependent = _task(1, deps=[0])
    q = ReadyQueue([dependent])
    assert not q.has_ready()
    q.complete(producer)               # foreign completion
    assert q.has_ready()
    t = q.try_dequeue()
    assert t is dependent
    q.complete(t)
    assert q.drained()
