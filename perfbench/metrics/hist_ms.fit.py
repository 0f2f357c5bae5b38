"""Device milliseconds a fit of the operations launched inside the
port's ``histogram`` or ``bin_codes`` profiler ranges (ops/hist.py
``HIST_RANGE``, ``CODES_RANGE``: a level's histogram and the bin codes,
whatever implements them). The ranges are read as one, so an operation
launched under both (``binned_left_stats`` makes its codes inside its
histogram range) counts once."""

import copy

RANGES = ("histogram", "bin_codes")


def read(run):
    if not run.calls:
        return None
    tr = copy.copy(run.trace)
    tr.ranges = [dict(r, name=RANGES[0]) if r["name"] in RANGES else r
                 for r in run.trace.ranges]
    s = tr.seconds_under_range(RANGES[0])
    return None if s is None else 1e3 * s / len(run.calls)
