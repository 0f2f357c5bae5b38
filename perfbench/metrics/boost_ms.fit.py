"""Device milliseconds a fit of the boosting's own work: the operations
launched inside the port's ``boost_round`` spans (models/gbt.py: one a
round of a replica chunk) but outside the ``tree_level`` and
``leaf_stats`` spans nested in them, read as the spans' profiler ranges:
the pseudo-residuals, the moments, the margin update and the round's
loss."""

import copy

ROUND = "boost_round"
INNER = ("tree_level", "leaf_stats")


def read(run):
    tr = run.trace
    total = tr.seconds_under_range(ROUND)
    if total is None or not run.calls:
        return None
    rounds = [(r["ts"], r["ts"] + r["dur"]) for r in tr.ranges
              if r["name"] == ROUND]
    inner = ROUND + "/inner"

    def nested(r):
        return r["name"] in INNER and any(s <= r["ts"] < e for s, e in rounds)

    view = copy.copy(tr)
    view.ranges = [dict(r, name=inner) if nested(r) else r
                   for r in tr.ranges]
    below = view.seconds_under_range(inner) or 0.0
    return 1e3 * (total - below) / len(run.calls)
