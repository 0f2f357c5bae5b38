"""Host milliseconds a fit in the port's ``estimator_fit`` span
(bagging.py ``fit``: the whole call) outside every program range nested
in it on its thread (``h2d``, ``fit``, ``aggregate``,
``quality_profile``, ...): the estimator's own host work (labels,
validation, the replica chunk's choice). The harness's ``perfbench:*``
ranges are not the program's and do not count."""

from bench import stats

SPAN = "estimator_fit"
HARNESS = "perfbench:"


def read(run):
    tr = run.trace
    outer = [r for r in tr.ranges
             if r["name"] == SPAN and tr.lo <= r["ts"] < tr.hi]
    if not outer or not run.calls:
        return None
    self_us = 0.0
    for o in outer:
        s, e = o["ts"], o["ts"] + o["dur"]
        inner = [(r["ts"], r["ts"] + r["dur"]) for r in tr.ranges
                 if r is not o and r.get("tid") == o.get("tid")
                 and not r["name"].startswith(HARNESS)
                 and s <= r["ts"] and r["ts"] + r["dur"] <= e]
        self_us += (e - s) - stats.union_length(inner, s, e)
    return self_us / 1e3 / len(outer)
