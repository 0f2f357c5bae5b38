"""The port's classifiers of the learner zoo against the JAX package.

Both packages fit the same bagged ensembles on the same numpy data (a
few hundred rows, 8 replicas, 80% feature subspaces): bootstrap
weights, subspaces and keys are bitwise equal (threefry), so the fitted
parameters differ by float32 rounding in another order only. Tolerances
(absolute, over ``max(1, |reference|)``), found on this CPU (jax 0.9.0,
torch 2.13):

- ``LogisticRegression(solver="adam")``, 60 full-batch Adam steps:
  coefficients within ADAM_TOL 1e-5 (found 4.8e-7), probabilities within
  PROBA_TOL 1e-5 (found 1.2e-7); ``optim.Adam`` is optax's arithmetic;
- the naive Bayes learners: parameters within NB_TOL 1e-5 (found
  2.3e-6, a Gaussian variance), probabilities within PROBA_TOL; the
  weighted class counts of integral weights bitwise;
- ``FMClassifier``, 50 Adam steps: parameters within FM_TOL 1e-5 (found
  1.1e-6), probabilities within PROBA_TOL (found 1.8e-7). At the card
  check's shapes (8 replicas, 20,000 covtype rows of 54 features, 8
  factors, 7 classes, 100 steps) within FM_LONG_TOL 5e-3 (found 2.8e-4
  in the parameters, 1.2e-4 in the probabilities): 100 Adam steps over
  a non-convex loss carry a last-bit difference far, and the card's
  sums, in yet another order, land 2.9e-3 from the CPU's (an H100);
- ``LinearSVC``: the loss curve within LOSS_TOL 1e-6 (found 1.2e-7) and
  probabilities within SVC_PROBA_TOL 1e-4 (found 2.1e-5); coefficients
  within SVC_W_TOL 5e-3 (found 1.03e-3). The squared hinge is piecewise
  quadratic: near the optimum the loss is flat along directions where a
  row's margin sits at 1 within rounding, and whether that row counts
  as active moves the Newton step along them (the replicas agree to 2.4e-7 for
  six iterations, then drift by up to 3.7e-4 in the seventh and eighth
  while their losses agree to 1.2e-7).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.models import naive_bayes as jnb  # noqa: E402
from spark_bagging_tpu_torch.models import naive_bayes as tnb  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import (  # noqa: E402
    make_classification,
)

ADAM_TOL = 1e-5
NB_TOL = 1e-5
FM_TOL = 1e-5
FM_LONG_TOL = 5e-3
PROBA_TOL = 1e-5
LOSS_TOL = 1e-6
SVC_W_TOL = 5e-3
SVC_PROBA_TOL = 1e-4
EST = dict(n_estimators=8, max_features=0.8, seed=3, oob_score=True)


def _data(n_classes):
    if n_classes == 2:
        return make_classification(400, 6, 2, seed=1)
    return make_classification(400, 6, 3, seed=0)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU fits here take one intra-op thread: under xdist each
    worker's default pool takes every core of the host and the workers'
    pools spin against one another (tests/test_torch_stream.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _close(got, want, tol, err_msg=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, err_msg
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{err_msg}: {err:.3g} > {tol} x {scale:.3g}"


def _fit_both(jl, tl, X, y, est=EST):
    jf = J.BaggingClassifier(jl, **est).fit(X, y)
    tf = T.BaggingClassifier(tl, device="cpu", **est).fit(X, y)
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    assert set(tf.ensemble_) == set(jf.ensemble_)
    return jf, tf


def _assert_ensembles(jf, tf, param_tol, proba_tol, X):
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), jf.ensemble_[k], param_tol, k)
    _close(tf.predict_proba(X), jf.predict_proba(X), proba_tol, "proba")
    np.testing.assert_array_equal(tf.predict(X), jf.predict(X))
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= LOSS_TOL
    assert abs(tf.oob_score_ - jf.oob_score_) <= 1e-6


@pytest.mark.parametrize("n_classes", [2, 3])
def test_logistic_adam_matches_jax(n_classes):
    X, y = _data(n_classes)
    kw = dict(solver="adam", max_iter=60, lr=0.05)
    jf, tf = _fit_both(J.LogisticRegression(**kw),
                       T.LogisticRegression(**kw), X, y)
    _assert_ensembles(jf, tf, ADAM_TOL, PROBA_TOL, X)


def test_logistic_adam_loss_curve_and_cost_model_match_jax():
    X, y = _data(3)
    rng = np.random.default_rng(0)
    w = rng.poisson(1.0, (4, 400)).astype(np.float32)
    kw = dict(solver="adam", max_iter=20, lr=0.05, l2=1e-2)
    jl, tl = J.LogisticRegression(**kw), T.LogisticRegression(**kw)
    p0 = jl.init_params(None, 6, 3)
    _, jaux = jax.vmap(lambda wr: jl.fit(
        p0, jnp.asarray(X), jnp.asarray(y), wr, None))(jnp.asarray(w))
    _, taux = tl.fit(tl.init_params(torch.zeros((4, 2), dtype=torch.int64),
                                    6, 3),
                     torch.from_numpy(X), torch.from_numpy(y),
                     torch.from_numpy(w), None)
    assert tuple(taux["loss_curve"].shape) == (4, 20)
    _close(taux["loss_curve"].numpy(), jaux["loss_curve"], LOSS_TOL)
    _close(taux["loss"].numpy(), jaux["loss"], LOSS_TOL)
    assert tl.flops_per_fit(1000, 6, 3) == jl.flops_per_fit(1000, 6, 3)
    assert tl.sgd_step_flops(1000, 6, 3) == jl.sgd_step_flops(1000, 6, 3)
    # the Adam path prices no Hessian
    assert tl.fit_workset_bytes(1000, 54, 7) < T.LogisticRegression(
    ).fit_workset_bytes(1000, 54, 7)


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("name", ["GaussianNB", "MultinomialNB",
                                  "BernoulliNB"])
def test_naive_bayes_matches_jax(name, n_classes):
    X, y = _data(n_classes)
    if name == "MultinomialNB":
        X = np.abs(X)  # counts are non-negative
    jf, tf = _fit_both(getattr(J, name)(), getattr(T, name)(), X, y)
    _assert_ensembles(jf, tf, NB_TOL, PROBA_TOL, X)


@pytest.mark.parametrize("kw", [dict(alpha=0.0), dict(alpha=0.5,
                                                      binarize=0.3)])
def test_bernoulli_nb_options_match_jax(kw):
    X, y = _data(3)
    jf, tf = _fit_both(J.BernoulliNB(**kw), T.BernoulliNB(**kw), X, y)
    _assert_ensembles(jf, tf, NB_TOL, PROBA_TOL, X)


@pytest.mark.parametrize("kw", [dict(var_smoothing=1e-3),
                                dict(var_smoothing=0.0)])
def test_gaussian_nb_smoothing_matches_jax(kw):
    X, y = _data(2)
    X = X + 1000.0  # features far from 0: the shifted moments hold
    jf, tf = _fit_both(J.GaussianNB(**kw), T.GaussianNB(**kw), X, y)
    # the shift (a weighted mean near 1000) differs by its float32 sum
    # order, and the means relative to it by as much the other way: the
    # class means themselves, the variances and the model agree
    tp = {k: v.numpy().astype(np.float64) for k, v in tf.ensemble_.items()}
    jp = {k: np.asarray(v, np.float64) for k, v in jf.ensemble_.items()}
    _close(tp["mean"] + tp["shift"][:, None], jp["mean"] + jp["shift"][:, None],
           NB_TOL, "class means")
    for k in ("var", "log_prior"):
        _close(tp[k], jp[k], NB_TOL, k)
    _close(tf.predict_proba(X), jf.predict_proba(X), PROBA_TOL, "proba")
    assert abs(tf.oob_score_ - jf.oob_score_) <= 1e-6


def test_multinomial_nb_alpha_zero_stays_finite_like_jax():
    X, y = _data(3)
    X = np.abs(X)
    X[:, 2] = 0.0  # a feature no class has: log(0) floored
    jf, tf = _fit_both(J.MultinomialNB(alpha=0.0),
                       T.MultinomialNB(alpha=0.0), X, y)
    assert np.isfinite(tf.predict_proba(X)).all()
    _assert_ensembles(jf, tf, NB_TOL, PROBA_TOL, X)


def test_nb_counts_of_integral_weights_are_bitwise():
    # Poisson counts times 0/1 features: integers, exact in any order
    X, y = _data(3)
    Xb = (X > 0).astype(np.float32)
    w = np.random.default_rng(1).poisson(1.0, (5, 400)).astype(np.float32)
    want = [jax.jit(lambda wr: jnb._weighted_class_counts(
        jnp.asarray(Xb), jnp.asarray(y), wr, 3, None))(jnp.asarray(wr))
        for wr in w]
    cls_w, w_sum, counts, _ = tnb._weighted_class_counts(
        torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(w), 3)
    for r in range(5):
        np.testing.assert_array_equal(cls_w[r].numpy(), np.asarray(want[r][0]))
        np.testing.assert_array_equal(w_sum[r].numpy(), np.asarray(want[r][1]))
        np.testing.assert_array_equal(counts[r].numpy(),
                                      np.asarray(want[r][2]))


@pytest.mark.parametrize("n_classes", [2, 3])
def test_fm_classifier_matches_jax(n_classes):
    X, y = _data(n_classes)
    kw = dict(factor_size=4, max_iter=50)
    jf, tf = _fit_both(J.FMClassifier(**kw), T.FMClassifier(**kw), X, y)
    _assert_ensembles(jf, tf, FM_TOL, PROBA_TOL, X)


def _fm_long_fit_both(n_rows: int):
    """FM classifiers of chip_smoke's device check (8 factors, 100 Adam
    steps, 8 replicas) on the first ``n_rows`` standardized covtype
    rows, in both packages, held to FM_LONG_TOL."""
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_covtype(n_rows)
    X = datasets.standardize(X)
    kw = dict(factor_size=8, max_iter=100)
    est = dict(n_estimators=8, seed=0)
    jf, tf = _fit_both(J.FMClassifier(**kw), T.FMClassifier(**kw), X, y,
                       est=est)
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), jf.ensemble_[k], FM_LONG_TOL, k)
    _close(tf.predict_proba(X), jf.predict_proba(X), FM_LONG_TOL, "proba")
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= 1e-5


# In `slow`: 86-98 s of tier-1 worker time under xdist (the port's side,
# 100 Adam steps over 8 x 20,000 rows on one thread, takes ~30 s alone).
# Tier-1 keeps test_fm_classifier_long_fit_matches_jax, the same learner,
# replicas, steps and tolerance on 4,000 rows.
@pytest.mark.slow
def test_fm_classifier_at_the_card_checks_shapes_matches_jax():
    _fm_long_fit_both(20_000)


def test_fm_classifier_long_fit_matches_jax():
    _fm_long_fit_both(4_000)


def test_fm_init_within_ulps_of_jax():
    # init_std x jax.random.normal of each replica's init key
    jl, tl = J.FMClassifier(factor_size=3), T.FMClassifier(factor_size=3)
    key = jax.random.key(4)
    want = jax.vmap(lambda r: jl.init_params(
        jax.random.fold_in(key, r), 5, 2))(jnp.arange(3))
    from spark_bagging_tpu_torch.ops import prng

    got = tl.init_params(prng.fold_in(prng.key(4), torch.arange(3)), 5, 2)
    np.testing.assert_array_equal(got["W"].numpy(), np.asarray(want["W"]))
    a = np.asarray(want["V"]).view(np.int32).astype(np.int64)
    b = got["V"].numpy().view(np.int32).astype(np.int64)
    assert got["V"].shape == (3, 5, 3, 2) and np.abs(a - b).max() <= 3


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("init", ["zeros", "pooled"])
def test_linear_svc_matches_jax(n_classes, init):
    X, y = _data(n_classes)
    jf, tf = _fit_both(J.LinearSVC(init=init), T.LinearSVC(init=init), X, y)
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), jf.ensemble_[k], SVC_W_TOL, k)
    _close(tf.predict_proba(X), jf.predict_proba(X), SVC_PROBA_TOL, "proba")
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= LOSS_TOL
    assert abs(tf.oob_score_ - jf.oob_score_) <= 1e-6


def test_linear_svc_loss_curve_matches_jax_and_never_rises():
    X, y = _data(3)
    w = np.random.default_rng(2).poisson(1.0, (6, 400)).astype(np.float32)
    w[5, 12:] = 0.0  # a 12-row draw: the small bag the line search guards
    jl, tl = J.LinearSVC(max_iter=8), T.LinearSVC(max_iter=8)
    p0 = jl.init_params(None, 6, 3)
    _, jaux = jax.vmap(lambda wr: jl.fit(
        p0, jnp.asarray(X), jnp.asarray(y), wr, None))(jnp.asarray(w))
    _, taux = tl.fit(tl.init_params(torch.zeros((6, 2), dtype=torch.int64),
                                    6, 3),
                     torch.from_numpy(X), torch.from_numpy(y),
                     torch.from_numpy(w), None)
    curve = taux["loss_curve"].numpy()
    _close(curve, jaux["loss_curve"], LOSS_TOL)
    _close(taux["loss"].numpy(), jaux["loss"], LOSS_TOL)
    assert (np.diff(curve, axis=1) <= 1e-7).all()


def test_svc_stream_matches_jax():
    from spark_bagging_tpu.utils.io import ArrayChunks as JChunks
    from spark_bagging_tpu_torch.utils.io import ArrayChunks as TChunks

    X, y = _data(3)
    est = dict(n_estimators=4, seed=1, oob_score=True)
    kw = dict(classes=[0, 1, 2], n_epochs=2, steps_per_chunk=2, lr=0.05)
    jf = J.BaggingClassifier(J.LinearSVC(), **est).fit_stream(
        JChunks(X, y, 128), **kw)
    tf = T.BaggingClassifier(T.LinearSVC(), device="cpu", **est).fit_stream(
        TChunks(X, y, 128), prefetch=0, **kw)
    _close(tf.ensemble_["W"].numpy(), jf.ensemble_["W"], ADAM_TOL, "W")
    _close(tf.predict_proba(X), jf.predict_proba(X), PROBA_TOL, "proba")
    assert abs(tf.oob_score_ - jf.oob_score_) <= 1e-6


@pytest.mark.parametrize("name", ["LinearSVC", "GaussianNB", "MultinomialNB",
                                  "BernoulliNB", "FMClassifier"])
def test_from_jax_arrays_predicts_like_jax(name):
    X, y = _data(3)
    if name == "MultinomialNB":
        X = np.abs(X)
    kw = dict(max_iter=20) if name == "FMClassifier" else {}
    jf = J.BaggingClassifier(getattr(J, name)(**kw), **EST).fit(X, y)
    tf = T.BaggingClassifier.from_jax_arrays(
        {k: np.asarray(v) for k, v in jf.ensemble_.items()},
        np.asarray(jf.subspaces_), classes=jf.classes_,
        n_features=jf.n_features_in_, base_learner=getattr(T, name)(**kw),
        device="cpu")
    _close(tf.predict_proba(X), jf.predict_proba(X), PROBA_TOL, name)


@pytest.mark.parametrize("name,kw", [
    ("LinearSVC", dict(max_iter=0)),
    ("LinearSVC", dict(init="warm")),
    ("MultinomialNB", dict(alpha=-1.0)),
    ("BernoulliNB", dict(alpha=-0.5)),
    ("FMClassifier", dict(factor_size=0)),
    ("FMClassifier", dict(max_iter=0)),
])
def test_rejects_what_jax_rejects(name, kw):
    with pytest.raises(ValueError):
        getattr(J, name)(**kw)
    with pytest.raises(ValueError):
        getattr(T, name)(**kw)


@pytest.mark.parametrize("name", ["LinearSVC", "GaussianNB", "MultinomialNB",
                                  "BernoulliNB", "FMClassifier"])
def test_cost_models_and_flags_equal_jax(name):
    jl, tl = getattr(J, name)(), getattr(T, name)()
    for n, d, c in ((581_012, 54, 7), (500, 7, 3)):
        assert tl.flops_per_fit(n, d, c) == jl.flops_per_fit(n, d, c)
        assert tl.sgd_step_flops(n, d, c) == jl.sgd_step_flops(n, d, c)
        assert tl.fit_workset_bytes(n, d, c) > 0
    assert tl.streamable == jl.streamable
    assert tl.uses_aux == jl.uses_aux is False
    assert tl.get_params() == jl.get_params()
