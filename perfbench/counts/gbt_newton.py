"""Work of a bag of binary Newton-boosted trees (``R`` replicas, ``M``
rounds of depth-``D`` trees over all ``F`` columns, ``B`` bins, ``K = 3``
moments), from the configuration's shapes.

Per replica and round: the pseudo-residuals, moments, margin update and
the round's loss cost ``ROUND_OPS`` a row (sigmoid 4, ``p (1 - p)`` and
its floor 3, ``h`` 1, ``z`` 2, ``h z`` and ``h z^2`` 2, the update 2, the
loss 4). Per level (``N = 2^level`` nodes): every row adds its 3 moments
into each of the ``F`` columns' histograms (``3 n F`` adds) and is routed
(``n`` compares); every candidate's left sums are a prefix sum over the
bins and its right sums a difference (``2 F B N K``), and its two squared
errors ``S2 - S1^2 / S0`` cost 3 each and their sum 1 (``7 F B N``). The
leaves add ``n`` rows' two moments (``2 n``) and divide (``L``), and the
binning compares every value with ``log2 B`` edges once a fit.

The histogram's least time follows ``tree_gini``'s shared-X bound with
what the fixed-point kernel reads and writes: each level reads the shared
bin codes (one byte each), every replica's moments (``(R, n, 3)``
float32) and node ids (int32), the replicas' edges, and writes every
replica's ``(F, B, N, 3)`` int64 table once; its adds run at the fp32
cores' rate. ``bin_codes`` reads X and writes one byte a code, once a
fit.
"""

from __future__ import annotations

import math

from counts import peaks

K = 3              # moments a row: (h, h z, h z^2)
ROUND_OPS = 18     # a row's elementwise work a round (see above)
TABLE_BYTES = 8    # the fixed-point accumulator's int64 entries


def shape(config: dict) -> dict:
    data, est = config["data"], config["estimator"]
    lp = est["learner"]["params"]
    F = int(data["n_features"])
    k = max(1, min(F, round(float(est["params"].get("max_features", 1.0))
                            * F)))
    return {"n": int(data["n_rows"]), "F": F, "k": k,
            "B": int(lp["n_bins"]), "D": int(lp["max_depth"]),
            "M": int(lp["n_rounds"]),
            "R": int(est["params"]["n_estimators"])}


def tree_flops(s: dict) -> float:
    """Operations of one replica's tree of one round, its round work
    included."""
    n, k, B, D = s["n"], s["k"], s["B"], s["D"]
    nodes = 2 ** D - 1
    return float(D * n * (K * k + 1) + k * B * nodes * (2 * K + 7)
                 + 2 * n + 2 ** D + ROUND_OPS * n)


def fit_flops(config: dict) -> float:
    """Operations of one fit: every replica's rounds and the binning."""
    s = shape(config)
    return float(s["R"] * s["M"] * tree_flops(s)
                 + s["n"] * s["F"] * math.log2(s["B"]))


def level_bytes(s: dict, level: int, code_bytes: float = 1.0) -> float:
    """Bytes one level's histogram reads and writes (the shared codes at
    ``code_bytes`` each)."""
    n, F, k, B, R = s["n"], s["F"], s["k"], s["B"], s["R"]
    N = 2 ** level
    return (code_bytes * n * F + 4.0 * R * n * K + 4.0 * R * n
            + 4.0 * R * k * B + TABLE_BYTES * R * k * B * N * K)


def level_least_seconds(s: dict, level: int) -> float:
    adds = float(s["R"]) * s["n"] * s["k"] * K
    return max(level_bytes(s, level) / peaks.BYTES, adds / peaks.FP32)


def codes_least_seconds(s: dict) -> float:
    return (4.0 + 1.0) * s["n"] * s["F"] / peaks.BYTES


def hist_least_seconds(config: dict) -> float:
    """The least time of one fit's histograms, every level of every
    round, and its bin codes."""
    s = shape(config)
    per_tree = sum(level_least_seconds(s, lv) for lv in range(s["D"]))
    return s["M"] * per_tree + codes_least_seconds(s)
