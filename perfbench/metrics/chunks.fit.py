"""Replica chunks a fit: the port's ``replica_chunk`` spans
(ensemble.py ``fit_ensemble``, one a chunk of replicas the memory model
let the engine fit at once) counted as profiler ranges in the traced
window, over its fits."""


def read(run):
    n = len(run.trace.range_seconds("replica_chunk"))
    return n / len(run.calls) if n and run.calls else None
