"""The idle-share and percentile arithmetic of the benchmark:
``busy_seconds`` is the union of device-operation intervals that the idle
share of a traced window is taken from (where ``chip_smoke.py``'s
``profile_solve`` summed the kernels' self times)."""

from __future__ import annotations

import math


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi] (same unit)."""
    total = 0.0
    for s, e in merge((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        total += e - s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of [lo, hi] between the ``intervals``."""
    out, cur = [], lo
    for s, e in merge((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100)."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
