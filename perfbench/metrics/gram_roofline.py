"""The scaled-Gram kernel's share of its roofline in a fit: the least
time of the fit's Grams (counts/<family>.gram_least_seconds, from the
configuration's shapes) over the device time of the kernels named here
(ops/gram.py + csrc/scaled_gram.cu: the tensor-core kernel and the sum
of its row-split partials), both over the traced fits."""

KERNELS = ("scaled_gram_mma", "sum_partials")


def read(run):
    least = getattr(run.counts, "gram_least_seconds", None)
    if least is None or not run.calls:
        return None
    t = run.trace.device_seconds(("kernel",), names=KERNELS)
    if t <= 0:
        return None
    return 100.0 * least(run.config) * len(run.calls) / t
