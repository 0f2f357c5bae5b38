"""Device milliseconds a fit of the operations launched inside the
port's ``fit_prepare`` span (ensemble.py ``fit_ensemble``: the
replica-invariant work, the trees' bin edges and codes, the logistic
bag's pooled start), read as the span's profiler range."""


def read(run):
    s = run.trace.seconds_under_range("fit_prepare")
    return None if s is None or not run.calls else 1e3 * s / len(run.calls)
