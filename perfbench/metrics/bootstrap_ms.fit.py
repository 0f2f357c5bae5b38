"""Device milliseconds a fit of the operations launched inside the
port's ``bootstrap_weights`` profiler range (ops/bootstrap.py
``DRAW_RANGE``: the threefry row draws)."""


def read(run):
    s = run.trace.seconds_under_range("bootstrap_weights")
    return None if s is None or not run.calls else 1e3 * s / len(run.calls)
