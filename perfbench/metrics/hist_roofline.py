"""The histogram kernels' share of their roofline in a fit: the least
time of every level's histogram and of the bin codes
(counts/<family>.hist_least_seconds, from the configuration's shapes)
over the device time of the kernels named here (ops/hist.py +
csrc/binned_left_stats.cu), both over the traced fits."""

KERNELS = ("hist_partial", "hist_finalize", "bin_codes_kernel")


def read(run):
    least = getattr(run.counts, "hist_least_seconds", None)
    if least is None or not run.calls:
        return None
    t = run.trace.device_seconds(("kernel",), names=KERNELS)
    if t <= 0:
        return None
    return 100.0 * least(run.config) * len(run.calls) / t
