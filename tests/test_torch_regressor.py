"""The port's regressors end to end against the JAX package's.

- ``BaggingRegressor(LinearRegression)``: ``subspaces_`` and
  ``replica_weights`` bitwise (the threefry draws); ``ensemble_["beta"]``
  within BETA_TOL of the largest |beta| (float32 normal equations
  summed and solved in other orders, as in test_torch_linear.py);
  ``predict`` and ``oob_prediction_`` within PRED_TOL absolute (a mean
  of X beta over replicas: the beta tolerance times |x| <= ~4);
  ``oob_score_`` within 1e-5.
- Regression trees: integer-valued y makes every moment sum an exact
  float32 integer, so ``feature``, ``threshold`` and ``gain`` are
  bitwise equal and leaf values within 2 ulps (a division); float y
  sums moments in another order, so its trees agree within tolerance
  (predictions within 1e-5 relative) and, on this data, split on the
  same features.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import make_regression  # noqa: E402

BETA_TOL = 1e-5
PRED_TOL = 1e-4
TREE = dict(max_depth=3, n_bins=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU fits here take one intra-op thread: under xdist each
    worker's default pool takes every core of the host and the workers'
    pools spin against one another (tests/test_torch_stream.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_beta_close(got, want, tol=BETA_TOL):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max |d beta| is {err:.3g} of max |beta| (> {tol})"


def assert_trees_equal(jparams, tparams):
    for k in ("feature", "threshold", "gain"):
        a, b = np.asarray(jparams[k]), _np(tparams[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_max_ulp(np.asarray(jparams["leaf_value"]),
                                    _np(tparams["leaf_value"]), maxulp=2)


@pytest.fixture(scope="module")
def data():
    return make_regression(400, 6, seed=0)


@pytest.fixture(scope="module")
def linear_fits(data):
    X, y = data
    est = dict(n_estimators=8, oob_score=True, seed=0)
    jr = J.BaggingRegressor(J.LinearRegression(l2=1e-4), **est).fit(X, y)
    tr = T.BaggingRegressor(T.LinearRegression(l2=1e-4), device="cpu",
                            **est).fit(X, y)
    return X, y, jr, tr


def test_linear_bagging_matches_jax(linear_fits):
    X, y, jr, tr = linear_fits
    assert set(tr.ensemble_) == {"beta"}
    np.testing.assert_array_equal(np.asarray(jr.subspaces_),
                                  tr.subspaces_.numpy())
    assert_beta_close(tr.ensemble_["beta"].numpy(),
                      np.asarray(jr.ensemble_["beta"]))
    np.testing.assert_allclose(tr.predict(X), jr.predict(X), atol=PRED_TOL,
                               rtol=0)
    assert abs(tr.score(X, y) - jr.score(X, y)) <= 1e-5
    rep = tr.fit_report_
    assert rep["n_replicas"] == 8 and rep["backend"] == "cpu"
    assert rep["model_flops_per_fit"] == jr.fit_report_["model_flops_per_fit"]


def test_linear_oob_matches_jax(linear_fits):
    X, y, jr, tr = linear_fits
    np.testing.assert_array_equal(np.isnan(jr.oob_prediction_),
                                  np.isnan(tr.oob_prediction_))
    np.testing.assert_allclose(tr.oob_prediction_, jr.oob_prediction_,
                               atol=PRED_TOL, rtol=0)
    assert abs(tr.oob_score_ - jr.oob_score_) <= 1e-5


@pytest.mark.parametrize("i", [0, 3, 7])
def test_replica_weights_and_params_bitwise(linear_fits, i):
    _, _, jr, tr = linear_fits
    np.testing.assert_array_equal(jr.replica_weights(i), tr.replica_weights(i))
    tp, tidx = tr.replica_params(i)
    jp, jidx = jr.replica_params(i)
    np.testing.assert_array_equal(np.asarray(jidx), tidx)
    assert_beta_close(tp["beta"], np.asarray(jp["beta"]))
    np.testing.assert_array_equal(tr.estimators_features_,
                                  np.asarray(jr.estimators_features_))
    assert isinstance(tr.base_learner_, T.LinearRegression)


@pytest.mark.parametrize("variant", ["chunked", "subspace", "bootstrap_features",
                                     "sample_weight", "max_samples"])
def test_linear_variants_match_jax(data, variant):
    X, y = data
    est = dict(n_estimators=6, seed=5)
    fit_kw = {}
    if variant == "chunked":
        est["chunk_size"] = 4
    elif variant == "subspace":
        est["max_features"] = 0.5
    elif variant == "bootstrap_features":
        est.update(max_features=5, bootstrap_features=True)
    elif variant == "sample_weight":
        fit_kw["sample_weight"] = np.random.default_rng(0).uniform(
            0.5, 2.0, len(y)).astype(np.float32)
    else:
        est.update(max_samples=0.3, bootstrap=False, oob_score=True)
    jr = J.BaggingRegressor(J.LinearRegression(l2=1e-3), **est).fit(
        X, y, **fit_kw)
    tr = T.BaggingRegressor(T.LinearRegression(l2=1e-3), device="cpu",
                            **est).fit(X, y, **fit_kw)
    np.testing.assert_array_equal(np.asarray(jr.subspaces_),
                                  tr.subspaces_.numpy())
    for i in (0, 5):
        np.testing.assert_array_equal(jr.replica_weights(i),
                                      tr.replica_weights(i))
    # repeated columns (bootstrap_features) make the Gram singular up to
    # the l2 penalty, which amplifies float32 rounding into beta; the
    # predictions, which only see the sums of repeated coefficients,
    # stay within the tolerance
    if variant != "bootstrap_features":
        assert_beta_close(tr.ensemble_["beta"].numpy(),
                          np.asarray(jr.ensemble_["beta"]))
    np.testing.assert_allclose(tr.predict(X), jr.predict(X), atol=PRED_TOL,
                               rtol=0)
    if est.get("oob_score"):
        np.testing.assert_allclose(tr.oob_prediction_, jr.oob_prediction_,
                                   atol=PRED_TOL, rtol=0)


@pytest.mark.parametrize("est", [dict(), dict(max_features=0.5),
                                 dict(max_features=4, bootstrap_features=True),
                                 dict(chunk_size=3)])
def test_linear_collapse_equals_the_device_forward(data, est):
    X, y = data
    tr = T.BaggingRegressor(T.LinearRegression(l2=1e-3), n_estimators=7,
                            seed=2, device="cpu", **est).fit(X, y)
    fn, params, subs = tr.aggregated_forward()
    Xt = torch.from_numpy(X)
    device = fn(params, subs, Xt).numpy()
    beta = tr._linear_collapse()
    assert beta.shape == (7,) and beta is tr._linear_collapse()  # cached
    np.testing.assert_allclose(tr.predict(X), device, atol=1e-5, rtol=0)
    # the per-replica forward averages to the same
    rfn, rp, rs = tr.replica_forward()
    per = rfn(rp, rs, Xt)
    assert tuple(per.shape) == (7, len(y))
    np.testing.assert_allclose(per.mean(0).numpy(), device, atol=1e-5, rtol=0)
    # a refit drops the cache
    tr.set_params(seed=3).fit(X, y)
    assert not np.array_equal(tr._linear_collapse(), beta)


def test_from_jax_arrays_predicts_like_jax(linear_fits, data):
    X, y, jr, _ = linear_fits
    port = T.BaggingRegressor.from_jax_arrays(
        {k: np.asarray(v) for k, v in jr.ensemble_.items()},
        np.asarray(jr.subspaces_), n_features=jr.n_features_in_,
        base_learner=T.LinearRegression(l2=1e-4), device="cpu")
    np.testing.assert_allclose(port.predict(X), jr.predict(X), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="fit key"):
        port.replica_weights(0)
    # a JAX forest's leaf_value carried across
    jf = J.RandomForestRegressor(n_estimators=3, seed=1, **TREE).fit(X, y)
    tf = T.BaggingRegressor.from_jax_arrays(
        {k: np.asarray(v) for k, v in jf.ensemble_.items()},
        np.asarray(jf.subspaces_), n_features=6,
        base_learner=T.DecisionTreeRegressor(**TREE), device="cpu")
    assert tf.ensemble_["feature"].dtype == torch.int32
    assert tf.ensemble_["leaf_value"].dtype == torch.float32
    np.testing.assert_allclose(tf.predict(X), jf.predict(X), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("target", ["integer", "float"])
def test_random_forest_regressor_matches_jax(data, target):
    X, y = data
    if target == "integer":
        y = np.round(y * 2).astype(np.float32)
    kw = dict(n_estimators=5, oob_score=True, seed=4, **TREE)
    jf = J.RandomForestRegressor(**kw).fit(X, y)
    tf = T.RandomForestRegressor(device="cpu", **kw).fit(X, y)
    assert tf.get_params()["feature_subset"] == "onethird"
    assert tf._fitted_learner._n_split_features(6) == 2
    np.testing.assert_array_equal(np.asarray(jf.subspaces_),
                                  tf.subspaces_.numpy())
    if target == "integer":
        assert_trees_equal(jf.ensemble_, tf.ensemble_)
    else:
        np.testing.assert_array_equal(np.asarray(jf.ensemble_["feature"]),
                                      tf.ensemble_["feature"].numpy())
        np.testing.assert_allclose(tf.ensemble_["leaf_value"].numpy(),
                                   np.asarray(jf.ensemble_["leaf_value"]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.predict(X), jf.predict(X), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tf.oob_prediction_, jf.oob_prediction_,
                               rtol=1e-5, atol=1e-5)
    assert abs(tf.oob_score_ - jf.oob_score_) <= 1e-5
    np.testing.assert_allclose(tf.feature_importances_,
                               jf.feature_importances_, atol=1e-6)


@pytest.mark.parametrize("split_impl", ["dense", "fused"])
def test_bagged_regression_trees_on_subspaces_match_jax(data, split_impl):
    # integer y: bitwise trees, both split searches (fused is the
    # histogram kernel's plain version here, the Pallas kernel in
    # interpret mode in JAX)
    X, y = data
    y = np.round(y).astype(np.float32)
    est = dict(n_estimators=4, max_features=0.8, oob_score=True, seed=1)
    jr = J.BaggingRegressor(
        J.DecisionTreeRegressor(split_impl=split_impl, **TREE), **est
    ).fit(X, y)
    tr = T.BaggingRegressor(
        T.DecisionTreeRegressor(split_impl=split_impl, **TREE), device="cpu",
        **est).fit(X, y)
    assert tr.subspaces_.shape == (4, 5)
    np.testing.assert_array_equal(np.asarray(jr.subspaces_),
                                  tr.subspaces_.numpy())
    assert_trees_equal(jr.ensemble_, tr.ensemble_)
    assert tr._linear_collapse() is None  # trees take the device forward
    np.testing.assert_allclose(tr.predict(X), jr.predict(X), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tr.oob_prediction_, jr.oob_prediction_,
                               rtol=1e-6, atol=1e-6)


def test_tree_prediction_through_the_column_index(data, monkeypatch):
    # trees score the shared X through each replica's columns: no
    # (R, n, k) gather, and the same predictions as the gathered form
    from spark_bagging_tpu_torch import ensemble

    X, y = data
    tr = T.BaggingRegressor(T.DecisionTreeRegressor(**TREE), n_estimators=5,
                            max_features=4, bootstrap_features=True, seed=3,
                            chunk_size=2, oob_score=True, device="cpu").fit(X, y)
    copies = []
    gather = ensemble._gather_columns
    monkeypatch.setattr(ensemble, "_gather_columns",
                        lambda *a: copies.append(1) or gather(*a))
    Xt = torch.from_numpy(X)
    learner = tr._fitted_learner
    got = ensemble.predict_scores_ensemble(
        learner, tr.ensemble_, tr.subspaces_, Xt, chunk_size=2)
    assert not copies
    want = learner.predict_scores(tr.ensemble_, gather(Xt, tr.subspaces_))
    assert torch.equal(got, want)
    # the estimator's mean sums chunk by chunk: equal up to that order
    np.testing.assert_allclose(tr.predict(X), got.mean(0).numpy(),
                               rtol=0, atol=1e-6)
    assert not copies


def test_regressor_surface_rules(data):
    X, y = data
    with pytest.raises(ValueError, match="uses_aux"):
        T.BaggingRegressor(device="cpu").fit(X, y, aux=np.ones(len(y)))
    with pytest.raises(ValueError, match="classification learner"):
        T.BaggingRegressor(T.LogisticRegression(), device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="regression learner"):
        T.BaggingClassifier(T.LinearRegression(), device="cpu").fit(
            X, (y > 0).astype(int))
    tr = T.BaggingRegressor(n_estimators=2, device="cpu")
    assert not hasattr(tr, "base_learner_")
    with pytest.raises(RuntimeError, match="not fitted"):
        tr.predict(X)
    tr.fit(X, y)
    with pytest.raises(AttributeError, match="predict_quantiles"):
        tr.predict_quantiles(X)
    with pytest.raises(IndexError):
        tr.replica_params(2)
    with pytest.raises(ValueError, match="features"):
        tr.predict(X[:, :3])
    # the streams run, and resume from a snapshot (a missing one raises)
    with pytest.raises(FileNotFoundError):
        tr.fit_stream((X, y), resume_from="no-such-snapshot")
    np.testing.assert_array_equal(tr.predict_stream((X, y)), tr.predict(X))
    assert tr.score_stream((X, y)) == pytest.approx(tr.score(X, y))
    # a data mesh fits any family: with every weight 1 the MLP's
    # data-parallel Adam steps are the single-device steps
    exact = dict(device="cpu", bootstrap=False)
    mlp_mesh = T.BaggingRegressor(T.MLPRegressor(hidden=4), **exact,
                                  mesh=T.make_mesh(
                                      2, devices=[torch.device("cpu")] * 2)
                                  ).fit(X, y)
    mlp = T.BaggingRegressor(T.MLPRegressor(hidden=4), **exact).fit(X, y)
    np.testing.assert_allclose(mlp_mesh.predict(X), mlp.predict(X),
                               atol=1e-5, rtol=0)
    # warm_start grows: the grown bag draws the cold fit's weights bit
    # for bit; its ridge solves, batched over 1 replica instead of 3,
    # round alike to within an ulp or two
    grown = T.BaggingRegressor(n_estimators=2, warm_start=True,
                               device="cpu").fit(X, y)
    grown.set_params(n_estimators=3).fit(X, y)
    cold = T.BaggingRegressor(n_estimators=3, device="cpu").fit(X, y)
    np.testing.assert_array_equal(grown.replica_weights(2),
                                  cold.replica_weights(2))
    np.testing.assert_allclose(grown.ensemble_["beta"].numpy(),
                               cold.ensemble_["beta"].numpy(), rtol=0,
                               atol=1e-6)


def test_regressors_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cls in (T.BaggingRegressor, T.RandomForestRegressor):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()
        assert cls(device="cpu").get_params()["device"] == "cpu"


def test_splits_survive_per_feature_rounding_of_the_table(monkeypatch):
    # on the card the kernel sums each feature's float moments in its own
    # order, so the features' node totals (edge B-1) differ by rounding.
    # Emulated here by scaling each feature's table by 1 + 4e-7 (f + 1):
    # the right side of a candidate must come from its own feature's
    # totals, or a side empty up to rounding scores s1^2 / 1e-12 and wins
    # every split (a forest of no-op splits, R^2 ~ 0)
    from spark_bagging_tpu_torch.ops import hist
    from spark_bagging_tpu_torch.utils import datasets
    from spark_bagging_tpu_torch.utils.metrics import r2_score

    X, y = datasets.synthetic_california(3000)
    Xtr, ytr, Xte, yte = datasets.train_test_split(datasets.standardize(X), y)
    kw = dict(n_estimators=6, max_depth=4, n_bins=16, split_impl="fused",
              seed=0, device="cpu")
    exact = T.RandomForestRegressor(**kw).fit(Xtr, ytr)
    coded = hist.coded_left_stats

    def rounded(*a, **k):
        out = coded(*a, **k)
        f = torch.arange(out.shape[1], dtype=torch.float32)
        return out * (1 + 4e-7 * (f + 1))[None, :, None, None, None]

    monkeypatch.setattr(hist, "coded_left_stats", rounded)
    noisy = T.RandomForestRegressor(**kw).fit(Xtr, ytr)
    r2 = [r2_score(yte, m.predict(Xte)) for m in (exact, noisy)]
    assert r2[0] > 0.5
    assert abs(r2[0] - r2[1]) <= 0.01, r2
    same = (exact.ensemble_["feature"] == noisy.ensemble_["feature"]).float()
    assert float(same.mean()) >= 0.9
