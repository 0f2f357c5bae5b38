"""Device-idle milliseconds a fit inside the boosting rounds: the part
of the union of the port's ``boost_round`` spans' profiler ranges
(models/gbt.py) in which the device ran no operation (kernel, copy or
fill), the host's pace through the round and level loop."""

from bench import stats


def read(run):
    tr = run.trace
    rounds = stats.merged([(r["ts"], r["ts"] + r["dur"]) for r in tr.ranges
                           if r["name"] == "boost_round"], tr.lo, tr.hi)
    if not rounds or not run.calls:
        return None
    busy = [(e["ts"], e["ts"] + e["dur"]) for e in tr.device]
    idle_us = sum((e - s) - stats.union_length(busy, s, e)
                  for s, e in rounds)
    return idle_us / 1e3 / len(run.calls)
