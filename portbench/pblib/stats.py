"""The end-to-end arithmetic: a tail over all events of the window and a
rate over all the work and all the time of the window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation between
    closest ranks (numpy's default), over every value."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(completed: int, window_s: float) -> float:
    """Events completed per second of the window."""
    return completed / window_s if window_s > 0 else math.nan
