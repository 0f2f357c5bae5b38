"""The 95th percentile of the host time of every whole predict call in
the window, in milliseconds."""

from bench import stats


def read(run):
    if not run.calls:
        return None
    return 1e3 * stats.percentile([c.end - c.start for c in run.calls], 95)
