"""Host milliseconds a predict call in the port's ``predict_h2d`` span
(bagging.py ``_device_predict``: the rows to the device, a pageable
copy the host waits for), read as the span's profiler range; the device
side of the same copy is ``h2d_ms.predict``."""


def read(run):
    spans = run.trace.range_seconds("predict_h2d")
    return 1e3 * sum(spans) / len(run.calls) if spans and run.calls else None
