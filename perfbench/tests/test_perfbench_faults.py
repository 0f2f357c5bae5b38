"""A whole run of each cell at a size the CPU holds, the chip check
skipped, with the timed path broken underneath: ``correct`` comes out
false for every fault the cell can have, and true with none, under the
cell's own limits. One chip, so no cell has an exchange between chips
to leave out."""

import os
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from bench import cell, drive  # noqa: E402

# a whole fit has to end inside the 2-s window: a few threads a process,
# so that test processes run side by side do not starve each other
torch.set_num_threads(2)

import spark_bagging_tpu_torch as port  # noqa: E402
from spark_bagging_tpu_torch import ensemble  # noqa: E402

SIZES = {"logistic": dict(n_rows=6000, n_predict_rows=1500, replicas=8),
         "trees": dict(n_rows=6000, n_predict_rows=1500, replicas=6)}


def _run(name: str, seed: int = 2**31 + 21) -> dict:
    c = cell.load(name, ROOT)
    s = SIZES["logistic" if "logistic" in name else "trees"]
    sizes = {"data": {"n_rows": s["n_rows"],
                      "n_predict_rows": s["n_predict_rows"]},
             "estimator": {"params": {"n_estimators": s["replicas"]}},
             "check": {"replicas": s["replicas"]}}
    return drive.run(c, seed, 2.0, False, time.perf_counter(), device="cpu",
                     sizes=sizes, log=open(os.devnull, "w"))


def _learner(name):
    return port.LogisticRegression if "logistic" in name \
        else port.DecisionTreeClassifier


def _unchanged(mp, name):
    """The learner's step returns the state it was given."""
    cls = _learner(name)

    def fit(self, params, X, y, sample_weight, keys, **kw):
        leaf = next(iter(params.values()))
        return params, {"loss": torch.zeros(leaf.shape[0])}

    mp.setattr(cls, "fit", fit)


def _half_rows(mp, name):
    """Half the rows left out of every replica's weights: its mean is
    then taken over the rest."""
    orig = ensemble.bootstrap_weights

    def weights(k, ids, n_rows, **kw):
        w = orig(k, ids, n_rows, **kw).clone()
        w[:, n_rows // 2:] = 0.0
        return w

    mp.setattr(ensemble, "bootstrap_weights", weights)


def _altered_fit(mp, name):
    """One answer of every replica altered where the fit makes it: a
    coefficient moved, or a threshold one float up."""
    cls = _learner(name)
    orig = cls.fit

    def fit(self, *a, **kw):
        params, aux = orig(self, *a, **kw)
        params = dict(params)
        if "W" in params:
            W = params["W"].clone()
            W[:, 0, 0] += 1e-2
            params["W"] = W
        else:
            t = params["threshold"].clone()
            t[:, 0] = torch.nextafter(t[:, 0], torch.tensor(float("inf")))
            params["threshold"] = t
        return params, aux

    mp.setattr(cls, "fit", fit)


def _half_replicas(mp, name):
    """Half the replicas left out of the vote, the mean taken over the
    rest."""
    orig = ensemble.predict_ensemble_classifier

    def forward(learner, params, subspaces, X, n_classes, n_total, **kw):
        h = max(1, subspaces.shape[0] // 2)
        return orig(learner, {k: v[:h] for k, v in params.items()},
                    subspaces[:h], X, n_classes, h, **kw)

    mp.setattr(ensemble, "predict_ensemble_classifier", forward)


def _altered_output(mp, name):
    """One served answer altered where it is produced."""
    orig = port.BaggingClassifier.predict_proba

    def predict_proba(self, X):
        out = orig(self, X).copy()
        out[0] = out[0][::-1].copy()
        return out

    mp.setattr(port.BaggingClassifier, "predict_proba", predict_proba)


FIT = ["fit.covtype_logistic", "fit.covtype_trees"]
PREDICT = ["predict.covtype_logistic", "predict.covtype_trees"]
CASES = ([(c, f) for c in FIT for f in (_unchanged, _half_rows, _altered_fit)]
         + [(c, f) for c in PREDICT
            for f in (_unchanged, _half_rows, _half_replicas,
                      _altered_output)])


@pytest.mark.parametrize("name", FIT + PREDICT)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    fault(monkeypatch, name)
    res = _run(name)
    assert res["correct"] is False, res["checks"]
