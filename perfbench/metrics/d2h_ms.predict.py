"""Device milliseconds a predict call of the operations launched inside
the port's ``predict_d2h`` span (bagging.py ``_device_predict``: the
result's copy back to the host), read as the span's profiler range."""


def read(run):
    s = run.trace.seconds_under_range("predict_d2h")
    return None if s is None or not run.calls else 1e3 * s / len(run.calls)
