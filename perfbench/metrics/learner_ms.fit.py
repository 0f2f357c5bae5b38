"""Device milliseconds a fit of the operations launched inside the
port's ``learner_fit`` spans (ensemble.py ``fit_ensemble``: the
learner's fit of each replica chunk, its Newton steps or tree levels and
their kernels), read as the spans' profiler ranges."""


def read(run):
    s = run.trace.seconds_under_range("learner_fit")
    return None if s is None or not run.calls else 1e3 * s / len(run.calls)
