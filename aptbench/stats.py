"""The benchmark's arithmetic: percentiles, spreads, unions of intervals."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all
    ``values``: the smallest value with at least ``q`` % of the values at
    or below it.  A failed sample is ``inf`` and counts as over any
    limit."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def spread(values) -> float:
    """The distance between the first and the third quartile as a share
    of the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals) -> float:
    """The length covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for a, b in merge((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out
