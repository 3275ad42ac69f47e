"""The closed-loop window and its arithmetic.

One caller issues calls back to back.  The window opens when the first
call starts and closes when the first call that ends after ``seconds``
ends, so every call in it is whole and a stall anywhere lowers the rate.
Where several processes share the loop, it closes one call later, after
the same call on each (``closed_loop``'s ``agree``).
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence


@dataclasses.dataclass
class Window:
    calls: int
    window_s: float
    latencies_s: List[float]
    last: object = None


def closed_loop(call: Callable[[int], object], seconds: float, *,
                keep: Optional[Callable[[int, object], None]] = None,
                agree: Optional[Callable[[bool], Callable[[], bool]]] = None,
                max_calls: Optional[int] = None,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run ``call(i)`` for i = 0, 1, ... until a call ends ``seconds``
    or more after the first began (or after ``max_calls`` calls).
    ``call`` returns once its work is done (it ends in a synchronise).
    ``keep(i, out)`` sees each result before the next call; of the
    results only the last call's is held past the next call's start.

    ``agree`` shares the loop with other processes: ``agree(wish)``
    posts this process's wish to stop without waiting for the others and
    returns a function that waits for every process's wish and says
    whether any wished it.  A call's wishes are read after the next
    call, so no call waits on the others, and every process stops after
    the same call: the one after the first that ended past ``seconds``
    on some process."""
    latencies: List[float] = []
    pending: Optional[Callable[[], bool]] = None
    i = 0
    t0 = clock()
    while True:
        start = clock()
        out = call(i)
        end = clock()
        latencies.append(end - start)
        if keep is not None:
            keep(i, out)
        i += 1
        wish = end - t0 >= seconds or (max_calls is not None
                                       and i >= max_calls)
        if agree is None:
            stop = wish
        else:
            stop = pending() if pending is not None else False
            pending = agree(wish)
        if stop:
            break
        out = None
    if pending is not None:
        pending()
    return Window(calls=i, window_s=end - t0, latencies_s=latencies,
                  last=out)


def drawn_calls(seed: int, k: int, below: int) -> List[int]:
    """``k`` distinct call indices under ``below``, drawn from ``seed``
    (all of them where ``below`` is ``k`` or fewer)."""
    if below <= k:
        return list(range(max(0, below)))
    return sorted(random.Random(seed).sample(range(below), k))


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} out of (0, 100]")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def beyond(values: Sequence[float], q: float) -> int:
    """How many values lie above the nearest-rank ``q``-th percentile."""
    p = nearest_rank(values, q)
    return sum(1 for v in values if v > p)


class Reservoir:
    """A uniform sample of ``k`` results in each group from a stream of
    unknown length (Algorithm R), drawn from ``seed``: the same seed and
    the same stream give the same sample.  Results not kept are dropped
    at once, so at most ``k`` a group are held."""

    def __init__(self, k: int, seed: int):
        if k < 1:
            raise ValueError("a sample holds at least one result")
        self.k = k
        self._rng = random.Random(seed)
        self._seen: Dict[object, int] = {}
        self._held: Dict[object, List[tuple]] = {}

    def offer(self, group, index: int, item) -> None:
        n = self._seen.get(group, 0)
        self._seen[group] = n + 1
        held = self._held.setdefault(group, [])
        if n < self.k:
            held.append((index, item))
            return
        slot = self._rng.randrange(n + 1)
        if slot < self.k:
            held[slot] = (index, item)

    def items(self) -> List[tuple]:
        """(index, item) of every held result, by index."""
        return sorted((x for held in self._held.values() for x in held),
                      key=lambda x: x[0])
