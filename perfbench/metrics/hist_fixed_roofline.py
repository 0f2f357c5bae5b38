"""The fixed-point histogram's share of its roofline in a fit: the least
time of every level's histogram and of the bin codes
(counts/<family>.hist_least_seconds, from the configuration's shapes)
over the device time of the operations launched inside the port's
``histogram`` and ``bin_codes`` profiler ranges (ops/hist.py), read as
one range as ``hist_ms.fit`` reads them, both over the traced fits. The
kernels are found by range, not by name, so the fixed-point scales and
the conversions back to float32 count with them."""

import copy

RANGES = ("histogram", "bin_codes")


def read(run):
    least = getattr(run.counts, "hist_least_seconds", None)
    if least is None or not run.calls:
        return None
    tr = copy.copy(run.trace)
    tr.ranges = [dict(r, name=RANGES[0]) if r["name"] in RANGES else r
                 for r in run.trace.ranges]
    t = tr.seconds_under_range(RANGES[0])
    if not t:
        return None
    return 100.0 * least(run.config) * len(run.calls) / t
