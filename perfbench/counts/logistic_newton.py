"""Work of a bag of damped-Newton logistic regressions with a pooled
start, from the configuration's shapes.

A Newton step on ``n`` rows of ``d = F + 1`` columns (bias included)
and ``C`` classes needs the scores ``X W`` and the gradient ``X^T G``
(``2 n d C`` each), the ``P = C (C + 1) / 2`` scaled Grams ``X^T diag(s)
X``, of which the ``i <= j`` half is needed (``n P d (d + 1)``), the
Cholesky factor of the ``(C d)^2`` Hessian (``(C d)^3 / 3``) and its
two triangular solves (``2 (C d)^2``). A fit takes ``pooled_iter``
steps at one replica and ``max_iter`` at each of ``n_estimators``.

The Grams' least time is the bound arithmetic of ``chip_smoke.py``
(:928-1000 at d3bc302), summed over the fit's steps: the larger of their
operations at the fastest fp32-accurate tensor-core rate (3xTF32) and
their bytes (X, each replica's scales, each Gram written once) at the
card's bandwidth. PERF.md's ``bound_ms`` at R = 121 (36.74 ms on
3xTF32, 90.49 on the fp32 cores) is this count at that shape.
"""

from __future__ import annotations

from counts import peaks


def shape(config: dict) -> dict:
    data, est = config["data"], config["estimator"]
    lp = est["learner"]["params"]
    C = int(data["n_classes"])
    return {"n": int(data["n_rows"]), "m": int(data["n_predict_rows"]),
            "d": int(data["n_features"]) + 1, "C": C,
            "P": C * (C + 1) // 2, "R": int(est["params"]["n_estimators"]),
            "steps": (int(lp["pooled_iter"])
                      + int(est["params"]["n_estimators"])
                      * int(lp["max_iter"]))}


def gram_ops(n: int, d: int, P: int, R: int) -> float:
    """Operations of ``R`` replicas' ``P`` scaled Grams, the ``i <= j``
    half of each, a multiply-add counting 2."""
    return float(n) * P * d * (d + 1) * R


def gram_bytes(n: int, d: int, P: int, R: int) -> float:
    """X and the replicas' scales read once, their Grams written once."""
    return 4.0 * (n * d + R * n * P + R * P * d * d)


def gram_least_seconds_at(n: int, d: int, P: int, R: int) -> dict:
    ops, nbytes = gram_ops(n, d, P, R), gram_bytes(n, d, P, R)
    t = {"3xtf32": ops / peaks.FP32_3XTF32, "fp32_cores": ops / peaks.FP32,
         "bytes": nbytes / peaks.BYTES}
    t["least"] = max(t["3xtf32"], t["bytes"])
    return t


def step_flops(n: int, d: int, C: int, P: int) -> float:
    Cd = C * d
    return 4.0 * n * d * C + gram_ops(n, d, P, 1) + Cd ** 3 / 3 + 2.0 * Cd ** 2


def fit_flops(config: dict) -> float:
    """FLOPs of one fit: every Newton step of the pooled start and of
    each replica."""
    s = shape(config)
    return s["steps"] * step_flops(s["n"], s["d"], s["C"], s["P"])


def gram_least_seconds(config: dict) -> float:
    """The least time of one fit's Grams: the pooled start's steps at
    one replica and each replica's own steps, every replica's in one
    pass over X."""
    s = shape(config)
    lp = config["estimator"]["learner"]["params"]
    pooled = gram_least_seconds_at(s["n"], s["d"], s["P"], 1)["least"]
    per = gram_least_seconds_at(s["n"], s["d"], s["P"], s["R"])["least"]
    return int(lp["pooled_iter"]) * pooled + int(lp["max_iter"]) * per


def predict_flops(config: dict) -> float:
    """FLOPs of one predict call: the scores of every replica on every
    row, ``2 m R (d + 1) C`` (the softmax and the sum are not counted)."""
    s = shape(config)
    return 2.0 * s["m"] * s["R"] * s["d"] * s["C"]
