"""Replicas of every whole fit that ended in the window, over the time
from the window's start to the end of the last of them."""

from bench import stats


def read(run):
    return stats.window_rate([c.units for c in run.calls],
                             [c.end for c in run.calls], run.window_start)
