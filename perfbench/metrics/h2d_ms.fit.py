"""Host milliseconds a fit in the port's ``h2d`` span (bagging.py
``_start_fit``: X to the device, then a device sync), read as the
span's profiler range in the traced window."""


def read(run):
    spans = run.trace.range_seconds("h2d")
    return 1e3 * sum(spans) / len(spans) if spans else None
