"""Device milliseconds a fit of the operations launched inside the
port's ``leaf_stats`` spans (models/tree.py ``_leaf_stats``: a tree's or
a boosting round's per-leaf sums, the one-hot product), read as the
spans' profiler ranges."""


def read(run):
    s = run.trace.seconds_under_range("leaf_stats")
    return None if s is None or not run.calls else 1e3 * s / len(run.calls)
