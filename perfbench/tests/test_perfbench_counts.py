"""The yardstick's counts of work against the bounds PERF.md's kernel
table states (``bound_ms``, made by chip_smoke.py's arithmetic), and
the counts of the two configurations (CPU)."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE]

from counts import logistic_newton, peaks, tree_gini  # noqa: E402


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_gram_bound_at_121_replicas_matches_the_kernel_table():
    # the headline's chunk: n = 581,012 rows, d = 55, P = 28, R = 121
    t = logistic_newton.gram_least_seconds_at(581_012, 55, 28, 121)
    assert 1e3 * t["3xtf32"] == pytest.approx(36.74, abs=0.01)
    assert 1e3 * t["fp32_cores"] == pytest.approx(90.49, abs=0.01)
    assert t["least"] == t["3xtf32"]  # operations bound it, not bytes


def test_gram_bound_at_one_replica_is_bytes_bound_as_stated():
    # R = 1: 0.304 ms on 3xTF32 against the bytes
    t = logistic_newton.gram_least_seconds_at(581_012, 55, 28, 1)
    assert 1e3 * t["3xtf32"] == pytest.approx(0.304, abs=0.001)


def test_headline_fit_counts():
    cfg = _config("covtype_logistic")
    s = logistic_newton.shape(cfg)
    assert (s["n"], s["d"], s["C"], s["P"], s["R"], s["steps"]) == \
        (581_012, 55, 7, 28, 1000, 1005)
    # ~50 TFLOP a fit, nearly all of it the Grams
    flops = logistic_newton.fit_flops(cfg)
    assert flops == pytest.approx(5.128e13, rel=0.001)
    grams = logistic_newton.gram_ops(581_012, 55, 28, 1005)
    assert grams / flops > 0.98
    # 5 pooled steps at R = 1 and one step of 1000 replicas
    least = logistic_newton.gram_least_seconds(cfg)
    assert least == pytest.approx(
        5 * logistic_newton.gram_least_seconds_at(581_012, 55, 28, 1)["least"]
        + logistic_newton.gram_least_seconds_at(581_012, 55, 28, 1000)["least"])
    assert least == pytest.approx(0.305, abs=0.002)
    assert logistic_newton.predict_flops(cfg) == pytest.approx(
        2 * 581_012 * 1000 * 55 * 7)


def test_tree_counts():
    cfg = _config("covtype_trees")
    s = tree_gini.shape(cfg)
    assert (s["n"], s["F"], s["k"], s["B"], s["C"], s["D"], s["R"]) == \
        (581_012, 54, 43, 32, 7, 5, 256)
    # the deepest level reads X, two (R, n) int32/float32 arrays and the
    # labels, writes the (R, k, B, 16, C) table: bytes bound it
    n, R = 581_012, 256
    nbytes = 4.0 * (n * 54 + 2 * R * n + n + R * 43 * 32
                    + R * 43 * 32 * 16 * 7)
    assert tree_gini.level_least_seconds(s, 4) == pytest.approx(
        nbytes / peaks.BYTES)
    assert tree_gini.codes_least_seconds(s) == pytest.approx(
        5.0 * n * 54 / peaks.BYTES)
    total = tree_gini.hist_least_seconds(cfg)
    assert 1.5e-3 < total < 3e-3
    assert tree_gini.fit_flops(cfg) == pytest.approx(3.35e10, rel=0.02)
