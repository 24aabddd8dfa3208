"""The numbers a correctness check compares, each a gap to the reference."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional


def relative_gap(got: Iterable[float], want: Iterable[float]) -> float:
    """Largest |got - want| / |want| over paired values."""
    return max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))


def leaf_norm_gap(got: Dict[str, float], want: Dict[str, float],
                  keep: Optional[Iterable[str]] = None, quantile: float = 1.0) -> float:
    """A leaf's |norm(got) - norm(want)| over the larger of the reference's
    norm of that leaf and of the median leaf: the worst leaf's (quantile 1),
    or the leaf's at `quantile` of them all (0.5: the median leaf's)."""
    names = list(keep) if keep is not None else list(want)
    med = statistics.median(want[n] for n in names)
    gaps = sorted(abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names)
    return gaps[min(len(gaps) - 1, int(quantile * len(gaps)))]


def moving_leaves(grad_norms: Dict[str, float], share: float = 1e-3):
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= share * med]
