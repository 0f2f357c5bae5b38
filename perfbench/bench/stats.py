"""The arithmetic the end-to-end and per-layer metrics are made of:
rates over a window, the call percentile, and unions and gaps of
device intervals. Pure functions of numbers, so the CPU tests hold them
to hand-made intervals."""

from __future__ import annotations

import numpy as np


def window_rate(units: list[float], ends: list[float],
                start: float) -> float | None:
    """Units a second over a closed loop's window: the units of every
    whole call that finished in the window, divided by the time from the
    window's start to the end of the last of them. None without a whole
    call."""
    if not ends:
        return None
    span = max(ends) - start
    if span <= 0:
        return None
    return float(sum(units)) / span


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile of every value (numpy's linear
    interpolation between order statistics)."""
    if not values:
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """Length of the union of ``[start, end)`` intervals, each clipped
    to ``[lo, hi]`` when given. The interval union of the port's
    ``profile_fit._busy_seconds`` (spark_bagging_tpu_torch/
    profile_fit.py:66-84 at d3bc302), frozen here, with the clip."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def merged(intervals, lo: float | None = None,
           hi: float | None = None) -> list[tuple[float, float]]:
    """The union of ``[start, end)`` intervals as sorted disjoint
    intervals, clipped to ``[lo, hi]``."""
    spans = []
    for s, e in intervals:
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e > s:
            spans.append((s, e))
    spans.sort()
    out: list[list[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle gaps of ``[lo, hi]``: where no interval covers it."""
    out, cur = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_share(intervals, lo: float, hi: float) -> float:
    """The share of ``[lo, hi]`` in which no interval is active."""
    if hi <= lo:
        raise ValueError("empty window")
    return 1.0 - union_length(intervals, lo, hi) / (hi - lo)

