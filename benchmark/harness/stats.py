"""Window arithmetic: rates over the whole window, tails over every
sample."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the two nearest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window: all the work done in it over
    all of its time."""
    if seconds <= 0.0:
        raise ValueError("a window of no time")
    return work / seconds

