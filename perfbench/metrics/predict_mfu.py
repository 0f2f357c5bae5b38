"""A whole predict call's share of the card's dense bf16 peak (989
TFLOP/s at 700 W): the configuration's FLOPs a call
(counts/<family>.predict_flops, from its shapes) over the traced
window's seconds a call."""

from counts import peaks


def read(run):
    flops = getattr(run.counts, "predict_flops", None)
    if flops is None or not run.calls:
        return None
    per_call = run.trace.window_s / len(run.calls)
    return 100.0 * flops(run.config) / per_call / peaks.BF16
