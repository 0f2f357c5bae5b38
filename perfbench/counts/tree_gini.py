"""Work of a bag of depth-``D`` binned Gini trees on ``k``-column
subspaces, from the configuration's shapes.

Per replica and level (``N = 2^level`` nodes): every row adds its count
into its class's cell of each of the ``k`` columns' histograms (``n k``
adds) and is routed (``n`` compares); every candidate's left sums are a
prefix sum over the bins and its right sums a difference (``2 k B N C``),
and its two Gini masses ``W - sum c^2 / W`` cost ``2 (2 C + 2)`` each
(``k B N (4 C + 4)``). The leaves add ``n`` counts, and the binning
compares every value with ``log2 B`` edges once a fit.

The histogram's least time, summed over the levels, follows
``chip_smoke.py``'s shared-X bound (:1500-1575 at d3bc302) with the
statistics as the configuration defines them: each level reads X, each
replica's counts and node ids and the labels once, the replicas' edges
once, and writes every replica's ``(k, B, N, C)`` table once; its adds
run at the fp32 cores' rate. ``bin_codes`` reads X and writes one byte
a code.
"""

from __future__ import annotations

import math

from counts import peaks


def shape(config: dict) -> dict:
    data, est = config["data"], config["estimator"]
    lp = est["learner"]["params"]
    F = int(data["n_features"])
    k = max(1, min(F, round(float(est["params"]["max_features"]) * F)))
    return {"n": int(data["n_rows"]), "F": F, "k": k,
            "C": int(data["n_classes"]), "B": int(lp["n_bins"]),
            "D": int(lp["max_depth"]), "R": int(est["params"]["n_estimators"])}


def fit_flops(config: dict) -> float:
    """Operations of one fit (adds, compares and the Gini arithmetic)."""
    s = shape(config)
    n, k, B, C, D, R = s["n"], s["k"], s["B"], s["C"], s["D"], s["R"]
    nodes = 2 ** D - 1
    per_replica = (D * n * (k + 1) + k * B * nodes * (2 * C + 4 * C + 4)
                   + n)
    return float(R * per_replica + s["n"] * s["F"] * math.log2(B))


def level_least_seconds(s: dict, level: int) -> float:
    n, F, k, B, C, R = s["n"], s["F"], s["k"], s["B"], s["C"], s["R"]
    N = 2 ** level
    nbytes = 4.0 * (n * F + 2 * R * n + n + R * k * B + R * k * B * N * C)
    adds = float(R) * n * k
    return max(nbytes / peaks.BYTES, adds / peaks.FP32)


def codes_least_seconds(s: dict) -> float:
    return (4.0 + 1.0) * s["n"] * s["F"] / peaks.BYTES


def hist_least_seconds(config: dict) -> float:
    """The least time of one fit's histograms, every level, and its bin
    codes."""
    s = shape(config)
    return (sum(level_least_seconds(s, lv) for lv in range(s["D"]))
            + codes_least_seconds(s))
