"""Device milliseconds a predict call of host-to-device copies (the
trace's HtoD memcpy operations: the rows handed over as host arrays)."""


def read(run):
    s = run.trace.device_seconds(("gpu_memcpy",), names=("HtoD",))
    return 1e3 * s / len(run.calls) if s > 0 and run.calls else None
