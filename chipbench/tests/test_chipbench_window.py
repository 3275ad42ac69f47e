"""The window's arithmetic: whole calls only, the nearest-rank
percentile and its sample count, the seeded sample."""
import pytest
import weakref

from yardstick.window import (Reservoir, beyond, closed_loop, drawn_calls,
                              nearest_rank)


class FakeClock:
    """A clock that each call advances by a fixed step."""

    def __init__(self, steps):
        self.t = 100.0
        self.steps = list(steps)

    def __call__(self):
        return self.t

    def run(self, i):
        self.t += self.steps[i % len(self.steps)]
        return i


def test_the_window_closes_at_the_first_call_ending_after_seconds():
    clock = FakeClock([0.4])
    win = closed_loop(clock.run, 1.0, clock=clock)
    # calls end at 0.4, 0.8, 1.2: the third is the first past 1.0
    assert win.calls == 3
    assert win.window_s == pytest.approx(1.2)
    assert win.latencies_s == pytest.approx([0.4, 0.4, 0.4])
    assert win.last == 2


def test_no_partial_call_is_counted():
    clock = FakeClock([0.3, 2.0])
    win = closed_loop(clock.run, 1.0, clock=clock)
    assert win.calls == 2 and win.window_s == pytest.approx(2.3)


def test_max_calls_and_agreement_stop_the_loop():
    clock = FakeClock([0.1])
    assert closed_loop(clock.run, 1e9, max_calls=5, clock=clock).calls == 5
    # another rank wants to stop after the fourth call: every rank reads
    # that after the fifth, and stops there
    votes = iter([False, False, False, True, False])
    posted, waited = [], []

    def agree(wish):
        posted.append(wish)
        vote = next(votes)

        def decided():
            waited.append(vote)
            return vote
        return decided
    win = closed_loop(clock.run, 1e9, agree=agree, clock=clock)
    assert win.calls == 5
    # each post is waited for once, the last one after the loop
    assert len(posted) == len(waited) == 5
    assert waited == [False, False, False, True, False]


def test_agreement_reads_this_ranks_own_wish_one_call_late():
    clock = FakeClock([0.4])
    win = closed_loop(clock.run, 1.0, clock=clock,
                      agree=lambda wish: (lambda: wish))
    # the third call is the first past 1.0; the loop stops after the fourth
    assert win.calls == 4 and win.window_s == pytest.approx(1.6)


class Out:
    pass


def test_only_the_last_result_outlives_the_next_call():
    refs = []

    def call(i):
        alive = [r() is not None for r in refs]
        out = Out()
        refs.append(weakref.ref(out))
        assert not any(alive), f"call {i} began with an earlier result held"
        return out
    win = closed_loop(call, float("inf"), max_calls=4)
    assert win.calls == 4 and refs[-1]() is win.last


def test_drawn_calls_are_the_seeds_and_below_the_bound():
    assert drawn_calls(5, 2, 100) == drawn_calls(5, 2, 100)
    assert len(set(drawn_calls(5, 3, 100))) == 3
    assert all(0 <= i < 100 for s in range(50) for i in drawn_calls(s, 1, 100))
    assert {drawn_calls(s, 1, 10)[0] for s in range(200)} == set(range(10))
    assert drawn_calls(5, 2, 2) == [0, 1] and drawn_calls(5, 1, 0) == []


def test_keep_sees_every_result_in_order():
    clock = FakeClock([0.5])
    seen = []
    closed_loop(clock.run, 1.0, keep=lambda i, out: seen.append((i, out)),
                clock=clock)
    assert seen == [(0, 0), (1, 1)]


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95, 95),
    (list(range(1, 101)), 50, 50),
    ([5.0, 1.0, 3.0], 95, 5.0),
    ([2.0], 95, 2.0),
    (list(range(1, 21)), 95, 19),
    (list(range(1, 21)), 100, 20),
])
def test_nearest_rank(values, q, want):
    assert nearest_rank(values, q) == want


def test_samples_beyond_the_percentile():
    values = list(range(1, 201))
    assert nearest_rank(values, 95) == 190
    assert beyond(values, 95) == 10


def test_nearest_rank_refuses_nothing_and_bad_q():
    with pytest.raises(ValueError):
        nearest_rank([], 95)
    with pytest.raises(ValueError):
        nearest_rank([1.0], 0)


def test_reservoir_is_the_seeds_and_bounded():
    def sample(seed, n=100, k=2):
        r = Reservoir(k, seed)
        for i in range(n):
            r.offer(i % 2, i, f"out{i}")
        return r.items()
    a, b = sample(7), sample(7)
    assert a == b and len(a) == 4
    assert {i % 2 for i, _ in a} == {0, 1}
    assert sample(7) != sample(8) or sample(7) != sample(9)
    assert [i for i, _ in sample(1, n=3, k=5)] == [0, 1, 2]


def test_reservoir_is_uniform():
    counts = [0] * 10
    for seed in range(3000):
        r = Reservoir(1, seed)
        for i in range(10):
            r.offer(0, i, i)
        counts[r.items()[0][0]] += 1
    assert min(counts) > 230 and max(counts) < 370
