"""End-to-end statistics over a measured window."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile of every value (q in (0, 100])."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def rate(work: Sequence[float], window_s: float) -> float:
    """Work completed over the whole window."""
    if window_s <= 0:
        raise ValueError("empty window")
    return float(sum(work)) / window_s
