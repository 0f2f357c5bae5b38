"""Device-idle milliseconds a fit while the port's engine ran: the part
of the union of its ``fit_prepare`` and ``replica_chunk`` spans'
profiler ranges (ensemble.py ``fit_ensemble``) in which the device ran
no operation (kernel, copy or fill)."""

from bench import stats

SPANS = ("fit_prepare", "replica_chunk")


def read(run):
    tr = run.trace
    engine = stats.merged([(r["ts"], r["ts"] + r["dur"]) for r in tr.ranges
                           if r["name"] in SPANS], tr.lo, tr.hi)
    if not engine or not run.calls:
        return None
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in tr.device]
    idle_us = sum((e - s) - stats.union_length(busy, s, e)
                  for s, e in engine)
    return idle_us / 1e3 / len(run.calls)
