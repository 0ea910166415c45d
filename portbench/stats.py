"""Percentiles and spreads as the benchmark reports them."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (nearest rank) of ``values``; a failed sample is
    ``math.inf`` and so counts as later than any limit."""
    xs = sorted(values)
    if not xs:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def spread(values: Iterable[float]) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    xs = list(values)
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / abs(med)
