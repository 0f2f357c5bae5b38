"""The soft-vote kernel's share of its roofline in a predict call: the
least time of a call's replica-summed soft vote over the device time of
the operations launched inside the program's ``soft_vote`` profiler
range (the port's ops/soft_vote.py ``SOFT_VOTE_RANGE``), found by the
range's name, so the share reads the same work whatever implements it.

The least time is the larger of the call's scores at the fastest
fp32-accurate tensor-core rate (3xTF32: counts/<family>.predict_flops)
and its bytes at the card's bandwidth: X (m rows of the configuration's
features), every replica's W ((d + 1) x C) and the (m, C) output, each
once. A program without the range (before the kernel) reads nothing."""

from counts import peaks


def least_seconds(config, counts) -> float | None:
    """The least time of one call, or None for a family without the
    counts."""
    shape = getattr(counts, "shape", None)
    flops = getattr(counts, "predict_flops", None)
    if shape is None or flops is None:
        return None
    s = shape(config)
    m, d1, C, R = s["m"], s["d"], s["C"], s["R"]
    nbytes = 4.0 * (m * (d1 - 1) + R * d1 * C + m * C)
    return max(flops(config) / peaks.FP32_3XTF32, nbytes / peaks.BYTES)


def read(run):
    if not run.calls:
        return None
    t = run.trace.seconds_under_range("soft_vote")
    least = least_seconds(run.config, run.counts)
    if not t or least is None:
        return None
    return 100.0 * least * len(run.calls) / t
