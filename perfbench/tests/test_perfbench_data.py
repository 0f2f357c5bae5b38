"""The generator and the reference's draws (CPU): the tables are a
function of the seed, the mixture is the port's synthetic covtype
mixture, and the frozen threefry copy draws the port's bootstrap bit for
bit."""

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from bench import data  # noqa: E402
from reference import threefry  # noqa: E402

SPEC = {**json.load(open(os.path.join(HERE, "configs",
                                      "covtype_logistic.json")))["data"],
        "n_rows": 4000, "n_predict_rows": 3000}
CPU = torch.device("cpu")


def test_tables_are_a_function_of_the_seed():
    a = data.make(SPEC, 2**31 + 9, CPU)
    b = data.make(SPEC, 2**31 + 9, CPU)
    c = data.make(SPEC, 2**31 + 10, CPU)
    for name in ("X_fit", "y_fit", "X_pred"):
        assert np.array_equal(getattr(a, name), getattr(b, name))
    assert not np.array_equal(a.X_fit, c.X_fit)
    assert a.X_fit.dtype == np.float32 and a.X_fit.shape == (4000, 54)
    assert a.y_fit.dtype == np.int64 and set(np.unique(a.y_fit)) <= set(range(7))
    assert a.X_pred.shape == (3000, 54)
    # standardised by the fit table's columns
    np.testing.assert_allclose(a.X_fit.mean(0), 0.0, atol=1e-5)
    np.testing.assert_allclose(a.X_fit.std(0), 1.0, atol=1e-4)
    assert not np.array_equal(a.X_fit[:3000], a.X_pred)


def test_mixture_is_the_ports_synthetic_covtype_mixture():
    from spark_bagging_tpu_torch.utils.datasets import synthetic_covtype

    centers, p = data.structure(SPEC)
    X, y = synthetic_covtype(500, seed=3, structure_seed=7)
    rng = np.random.default_rng(3)
    y2 = rng.choice(7, size=500, p=p).astype(np.int32)
    noise = rng.standard_normal((500, 54), np.float32)
    assert np.array_equal(y, y2)
    np.testing.assert_allclose(X - noise, centers[y], atol=1e-6)


def test_threefry_copy_draws_the_ports_bootstrap_bit_for_bit():
    from spark_bagging_tpu_torch.ops import prng
    from spark_bagging_tpu_torch.ops.bootstrap import (
        bootstrap_weights,
        feature_subspaces,
    )

    for seed in (0, 7, 2**32 - 1, 2**31 + 12345):
        k = prng.key(seed)
        ids = torch.tensor([0, 3, 255], dtype=torch.int64)
        w = bootstrap_weights(k, ids, 5000)
        cols = feature_subspaces(k, ids, 54, 43)
        for i, r in enumerate(ids.tolist()):
            assert torch.equal(threefry.row_counts(seed, r, 5000, CPU), w[i])
            assert torch.equal(threefry.subspace(seed, r, 54, 43, CPU),
                               cols[i].long())
        assert torch.equal(threefry.subspace(seed, 1, 54, 54, CPU),
                           torch.arange(54))
