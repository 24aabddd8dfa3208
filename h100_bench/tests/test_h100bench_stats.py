"""The end-to-end statistics: a tail over every unit, rates over the whole
window, and a planted stall that must move both."""
from __future__ import annotations

import pytest

from h100_bench.core.stats import percentile, rate
from h100_bench.core.window import run_window


class FakeClock:
    """A clock that a step advances by its own duration."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def window(durations, seconds):
    clock = FakeClock()
    it = iter(durations)

    def step():
        clock.t += next(it)
        return 2.0

    return run_window(step, seconds, "cpu", clock=clock)


def test_percentile_is_nearest_rank_over_all_values():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([5.0], 95) == 5.0
    assert percentile([3, 1, 2, 4], 50) == 2
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_is_work_over_the_whole_window():
    assert rate([2, 2, 2], 3.0) == 2.0
    with pytest.raises(ValueError):
        rate([1], 0.0)


def test_window_counts_every_unit_until_the_deadline():
    rec = window([0.125] * 100, 1.0)
    assert len(rec.work) == 8 and rec.window_s == 1.0
    assert rec.rate() == 16.0
    assert rec.index == list(range(8))


def test_a_planted_stall_moves_the_rate_and_the_tail():
    steady = window([0.125] * 200, 2.0)
    stalled = window([0.125] * 8 + [0.5] + [0.125] * 200, 2.0)
    assert stalled.rate() < 0.85 * steady.rate()
    # a stall past the deadline still counts: the window ends with the unit
    late = window([0.125] * 15 + [3.0], 2.0)
    assert late.window_s == 4.875 and late.rate() < 0.5 * steady.rate()
    assert percentile(late.latencies(), 95) == 3.0
    lat = [0.1] * 30 + [0.5] * 2
    assert percentile(lat, 95) == 0.5 and percentile(lat[:30], 95) == 0.1
