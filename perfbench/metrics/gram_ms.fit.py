"""Device milliseconds a fit of the operations launched inside the
port's ``scaled_grams`` profiler range (ops/gram.py ``GRAM_RANGE``: the
scaled-Gram launch and the sum of its partials, whatever implements
them)."""


def read(run):
    s = run.trace.seconds_under_range("scaled_grams")
    return None if s is None or not run.calls else 1e3 * s / len(run.calls)
