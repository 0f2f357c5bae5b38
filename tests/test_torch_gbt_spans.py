"""The boosting spans and counters of the port's GBT fits (CPU).

A binary and a multiclass ``BaggingClassifier(GBTClassifier)`` in two
replica chunks record, under ``telemetry.capture()``, one
``boost_round`` a round of each chunk's ``learner_fit`` (attr
``round``), the round's ``tree_level`` spans and one ``leaf_stats``
inside it; ``sbt_gbt_rounds_total`` and ``sbt_gbt_trees_total`` count
the rounds and the trees grown, once a learner fit. A Gini tree bag
opens ``leaf_stats`` once a chunk. The fitted state is bitwise the same
with telemetry captured and without.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import (  # noqa: E402
    make_classification,
)

R, CHUNK, ROUNDS, DEPTH = 5, 3, 3, 2
N_CHUNKS = math.ceil(R / CHUNK)
LEARNER = "estimator_fit/fit/replica_chunk/learner_fit"


def _gbt(n_classes):
    X, y = make_classification(300, 6, n_classes, seed=3)
    est = T.BaggingClassifier(
        T.GBTClassifier(n_rounds=ROUNDS, max_depth=DEPTH, n_bins=8),
        n_estimators=R, chunk_size=CHUNK, seed=0, device="cpu")
    return est, X, y


def _trees():
    X, y = make_classification(300, 6, 3, seed=3)
    est = T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=DEPTH, n_bins=8),
        n_estimators=R, chunk_size=CHUNK, seed=0, device="cpu")
    return est, X, y


def _counter(name):
    return sum(s["value"] for s in telemetry.registry().snapshot()
               if s["name"] == name)


def _captured(make):
    est, X, y = make()
    telemetry.reset()
    try:
        with telemetry.capture() as run:
            est.fit(X, y)
        counts = {k: _counter(k) for k in ("sbt_gbt_rounds_total",
                                           "sbt_gbt_trees_total")}
    finally:
        telemetry.reset()
    return est, run.spans(), counts


@pytest.fixture(scope="module")
def recorded():
    return {"binary": _captured(lambda: _gbt(2)),
            "multiclass": _captured(lambda: _gbt(3)),
            "trees": _captured(_trees)}


def _paths(spans, name):
    return [e["path"] for e in spans if e["name"] == name]


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_rounds_nest_levels_and_leaf_sums(recorded, kind):
    _, spans, _ = recorded[kind]
    rounds = [e for e in spans if e["name"] == "boost_round"]
    assert [e["path"] for e in rounds] == (
        [f"{LEARNER}/boost_round"] * (ROUNDS * N_CHUNKS))
    assert [e["attrs"]["round"] for e in rounds] == (
        list(range(ROUNDS)) * N_CHUNKS)
    assert _paths(spans, "tree_level") == (
        [f"{LEARNER}/boost_round/tree_level"]
        * (DEPTH * ROUNDS * N_CHUNKS))
    assert _paths(spans, "leaf_stats") == (
        [f"{LEARNER}/boost_round/leaf_stats"] * (ROUNDS * N_CHUNKS))
    # each round's levels and leaf sums lie inside that round
    for e in spans:
        if e["name"] not in ("tree_level", "leaf_stats"):
            continue
        outer = [r for r in rounds if r["ts"] <= e["ts"]]
        r = max(outer, key=lambda r: r["ts"])
        assert e["ts"] + e["seconds"] <= r["ts"] + r["seconds"] + 1e-3


@pytest.mark.parametrize("kind,trees", [("binary", 1), ("multiclass", 3)])
def test_counters_count_rounds_and_trees(recorded, kind, trees):
    _, _, counts = recorded[kind]
    assert counts["sbt_gbt_rounds_total"] == ROUNDS * N_CHUNKS
    assert counts["sbt_gbt_trees_total"] == ROUNDS * R * trees


def test_gini_tree_fit_opens_leaf_stats_once_a_chunk(recorded):
    _, spans, counts = recorded["trees"]
    assert _paths(spans, "leaf_stats") == (
        [f"{LEARNER}/leaf_stats"] * N_CHUNKS)
    assert not _paths(spans, "boost_round")
    assert counts == {"sbt_gbt_rounds_total": 0, "sbt_gbt_trees_total": 0}


@pytest.mark.parametrize("kind", ["binary", "multiclass", "trees"])
def test_fitted_state_is_bitwise_the_same_without_telemetry(recorded, kind):
    captured, _, _ = recorded[kind]
    make = _trees if kind == "trees" else (
        lambda: _gbt(2 if kind == "binary" else 3))
    plain, X, y = make()
    was = telemetry.enabled()
    telemetry.disable()
    try:
        plain.fit(X, y)
    finally:
        if was:
            telemetry.enable()
    assert set(plain.ensemble_) == set(captured.ensemble_)
    for k, v in captured.ensemble_.items():
        assert torch.equal(plain.ensemble_[k], v), k
    assert torch.equal(plain.subspaces_, captured.subspaces_)
    np.testing.assert_array_equal(plain.predict_proba(X),
                                  captured.predict_proba(X))
