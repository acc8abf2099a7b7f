"""The benchmark's arithmetic, kept plain so that tests pin it."""

from __future__ import annotations

import numpy as np


def rate(count: float, seconds: float) -> float:
    """Work over all the window's time."""
    return count / seconds


def p95(values) -> float:
    """The 95th percentile of every value (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: time in which at least
    one of them runs."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, t0: float, t1: float) -> list[tuple]:
    """The parts of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)
