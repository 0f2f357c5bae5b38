"""The port's regressors of the learner zoo, the survival learner's aux
channel and quantiles, against the JAX package.

Both packages fit the same bagged ensembles on the same numpy data (400
rows, 8 replicas, 80% feature subspaces; bootstrap weights, subspaces
and keys bitwise equal). Tolerances (absolute, over ``max(1,
|reference|)``), found on this CPU (jax 0.9.0, torch 2.13):

- ``GeneralizedLinearRegression``, every family and the non-default
  links, 8 IRLS iterations: the objective (the fit's mean loss and its
  curve) within LOSS_TOL 1e-6 (found 2.3e-7); coefficients and
  predictions within GLM_TOL 5e-4 (found 2.1e-4, tweedie with p = 1.2,
  and 1.2e-4 for the pooled gaussian), and for the gaussian family's log
  link, not convex and slow to settle, within GLM_FLAT_TOL 5e-3 (found
  2.2e-3 in beta, 5.3e-3 in a prediction of scale ~3). Near the optimum
  the line search's candidate losses tie within rounding, and its first
  minimum then picks another step size on each side: that moves beta
  by the remaining Newton step (the losses still agree to 1e-8). These
  are flips of ``argmin`` over ``_STEPS`` on tied losses, not faults;
  inputs: ``make_regression(400, 5, seed=0)``, EST below;
- ``FMRegressor``, 50 Adam steps: parameters within FM_TOL 1e-5 (found
  2.5e-6), predictions within PRED_TOL 1e-5; at the card check's shapes
  (8 replicas, config 2's 16,512 rows, 8 factors, 100 steps) within
  FM_LONG_TOL 5e-3 (found 1.7e-5; the Adam fit amplifies last-bit
  differences, tests/test_torch_zoo_clf.py);
- the binomial GLM at the card check's shapes (8 replicas, 20,000
  covtype rows of 54 features, target ``y == 1``): coefficients and
  predictions within GLM_FLAT_TOL (found 3.1e-4 and 3.7e-5: the logit's
  large coefficients sit on flat directions, where the line search's
  tied candidates pick other steps), the mean loss within LOSS_TOL;
- ``IsotonicRegression``: bin values and centers within ISO_TOL 1e-5
  (found 1.2e-6), predictions within PRED_TOL (found 1.3e-7);
- ``AFTSurvivalRegression`` with 20% of rows censored through ``aux``,
  100 Adam steps: parameters, predictions and ``predict_quantiles``
  within AFT_TOL 2e-4 (found 5.4e-5 in beta, 3.9e-5 in the quantiles:
  Adam carries the exp/log rounding of the likelihood forward, as the
  MLP's long fits do, tests/test_torch_mlp.py); streamed fits with
  ``aux_col`` within the same.
"""

import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.utils.io import ArrayChunks as JChunks  # noqa: E402
from spark_bagging_tpu_torch.streaming import split_aux_col  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import make_regression  # noqa: E402
from spark_bagging_tpu_torch.utils.io import ArrayChunks as TChunks  # noqa: E402

GLM_TOL = 5e-4
GLM_FLAT_TOL = 5e-3
FM_TOL = 1e-5
FM_LONG_TOL = 5e-3
ISO_TOL = 1e-5
AFT_TOL = 2e-4
PRED_TOL = 1e-5
LOSS_TOL = 1e-6
EST = dict(n_estimators=8, max_features=0.8, seed=3, oob_score=True)



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


def _data():
    X, y = make_regression(400, 5, seed=0)
    return X, y


def _target(family, y):
    if family == "binomial":
        return (y > np.median(y)).astype(np.float32)
    if family == "gaussian":
        return y
    pos = (y - y.min() + 0.5).astype(np.float32)
    return (pos / pos.mean()).astype(np.float32)


def _survival():
    """Weibull-ish times driven by feature 0, 20% right-censored."""
    X, _ = _data()
    rng = np.random.default_rng(0)
    t = np.exp(0.3 * X[:, 0] + 0.1 * rng.standard_normal(len(X)))
    cens = (rng.random(len(X)) > 0.2).astype(np.float32)
    return X, t.astype(np.float32), cens


def _fit_both(jl, tl, X, y, est=EST, **fit_kw):
    jf = J.BaggingRegressor(jl, **est).fit(X, y, **fit_kw)
    tf = T.BaggingRegressor(tl, device="cpu", **est).fit(X, y, **fit_kw)
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    assert set(tf.ensemble_) == set(jf.ensemble_)
    return jf, tf


def _assert_ensembles(jf, tf, tol, X, pred_tol=None):
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), jf.ensemble_[k], tol, k)
    _close(tf.predict(X), jf.predict(X), pred_tol or tol, "predict")
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= max(LOSS_TOL, tol)
    assert abs(tf.oob_score_ - jf.oob_score_) <= max(1e-6, tol)


@pytest.mark.parametrize("family,link,kw", [
    ("gaussian", None, {}), ("gaussian", "log", {}), ("poisson", None, {}),
    ("poisson", "identity", {}), ("gamma", None, {}),
    ("binomial", None, {}), ("tweedie", None, {}),
    ("tweedie", None, dict(variance_power=1.2)),
    ("poisson", None, dict(init="pooled")),
    ("gaussian", None, dict(init="pooled", l2=1e-2)),
])
def test_glm_matches_jax(family, link, kw):
    X, y = _data()
    y = _target(family, y)
    args = dict(family=family, link=link, **kw)
    jf, tf = _fit_both(J.GeneralizedLinearRegression(**args),
                       T.GeneralizedLinearRegression(**args), X, y)
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= LOSS_TOL
    flat = (family, link) == ("gaussian", "log")
    _assert_ensembles(jf, tf, GLM_FLAT_TOL if flat else GLM_TOL, X)


def test_glm_loss_curve_matches_jax_and_never_rises():
    X, y = _data()
    y = _target("gamma", y)
    w = np.random.default_rng(5).poisson(1.0, (4, 400)).astype(np.float32)
    jl = J.GeneralizedLinearRegression(family="gamma", max_iter=6)
    tl = T.GeneralizedLinearRegression(family="gamma", max_iter=6)
    p0 = jl.init_params(None, 5, 1)
    _, jaux = jax.vmap(lambda wr: jl.fit(
        p0, jnp.asarray(X), jnp.asarray(y), wr, None))(jnp.asarray(w))
    _, taux = tl.fit(tl.init_params(torch.zeros((4, 2), dtype=torch.int64),
                                    5, 1),
                     torch.from_numpy(X), torch.from_numpy(y),
                     torch.from_numpy(w), None)
    curve = taux["loss_curve"].numpy()
    _close(curve, jaux["loss_curve"], LOSS_TOL)
    _close(taux["loss"].numpy(), jaux["loss"], LOSS_TOL)
    assert (np.diff(curve, axis=1) <= 1e-7).all()


@pytest.mark.parametrize("family", ["poisson", "gamma", "binomial",
                                    "tweedie"])
def test_glm_deviance_and_links_equal_jax(family):
    # the per-row deviance at means near the clamps, and the log link's
    # clip of eta at +-30
    rng = np.random.default_rng(7)
    y = rng.uniform(0.0, 1.0, 200).astype(np.float32)
    y[:5] = 0.0
    mu = np.concatenate([rng.uniform(1e-9, 1.0, 195),
                         [0.0, 1e-12, 1.0, 1.0 - 1e-9, 0.5]]).astype(np.float32)
    jl = J.GeneralizedLinearRegression(family=family)
    tl = T.GeneralizedLinearRegression(family=family)
    # at mu = 1 the binomial deviance of y < 1 is +inf on both sides
    np.testing.assert_allclose(
        tl._unit_deviance(torch.from_numpy(y), torch.from_numpy(mu)).numpy(),
        np.asarray(jl._unit_deviance(jnp.asarray(y), jnp.asarray(mu))),
        rtol=1e-5, atol=1e-6, err_msg=family)
    eta = np.array([-40.0, -30.0, 0.0, 29.0, 45.0], np.float32)
    np.testing.assert_allclose(tl._mean(torch.from_numpy(eta)).numpy(),
                               np.asarray(jl._mean(jnp.asarray(eta))),
                               rtol=1e-6, atol=0)


def test_glm_identity_link_collapses_and_others_use_the_device_forward():
    X, y = _data()
    tf = T.BaggingRegressor(T.GeneralizedLinearRegression(), n_estimators=4,
                            device="cpu").fit(X, y)
    assert tf._linear_collapse() is not None
    fn, params, subs = tf.aggregated_forward()
    _close(tf.predict(X), fn(params, subs, torch.from_numpy(X)).numpy(),
           1e-5)
    tl = T.BaggingRegressor(T.GeneralizedLinearRegression(family="poisson"),
                            n_estimators=4, device="cpu").fit(
        X, _target("poisson", y))
    assert tl._linear_collapse() is None
    assert np.isfinite(tl.predict(X)).all()


def test_fm_regressor_matches_jax():
    X, y = _data()
    y = ((y - y.mean()) / y.std()).astype(np.float32)
    kw = dict(factor_size=4, max_iter=50)
    jf, tf = _fit_both(J.FMRegressor(**kw), T.FMRegressor(**kw), X, y)
    _assert_ensembles(jf, tf, FM_TOL, X, PRED_TOL)


def test_fm_regressor_at_the_card_checks_shapes_matches_jax():
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_california(20_640)
    X, y, _, _ = datasets.train_test_split(datasets.standardize(X), y)
    y = ((y - y.mean()) / y.std()).astype(np.float32)
    kw = dict(factor_size=8, max_iter=100)
    jf, tf = _fit_both(J.FMRegressor(**kw), T.FMRegressor(**kw), X, y,
                       est=dict(n_estimators=8, seed=0, oob_score=True))
    _assert_ensembles(jf, tf, FM_LONG_TOL, X)


def test_glm_binomial_at_the_card_checks_shapes_matches_jax():
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_covtype(20_000)
    X = datasets.standardize(X)
    yb = (y == 1).astype(np.float32)
    args = dict(family="binomial")
    jf, tf = _fit_both(J.GeneralizedLinearRegression(**args),
                       T.GeneralizedLinearRegression(**args), X, yb,
                       est=dict(n_estimators=8, seed=0, oob_score=True))
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= LOSS_TOL
    _assert_ensembles(jf, tf, GLM_FLAT_TOL, X)


@pytest.mark.parametrize("kw", [dict(n_bins=32), dict(n_bins=32,
                                                      increasing=False),
                                dict(n_bins=600)])
def test_isotonic_matches_jax(kw):
    X, y = _data()
    if not kw.get("increasing", True):
        y = -y
    jf, tf = _fit_both(J.IsotonicRegression(**kw),
                       T.IsotonicRegression(**kw), X, y)
    _assert_ensembles(jf, tf, ISO_TOL, X, PRED_TOL)


def test_isotonic_is_monotone_and_exact_on_distinct_bins():
    # n <= n_bins: every x in a bin of its own, so the fit is PAV's
    rng = np.random.default_rng(4)
    x = np.sort(rng.standard_normal(40)).astype(np.float32)
    y = (x + rng.standard_normal(40)).astype(np.float32)
    X = x[:, None]
    tl = T.IsotonicRegression(n_bins=64)
    prep = tl.prepare(torch.from_numpy(X))
    w = torch.ones((1, 40))
    p, _ = tl.fit(None, torch.from_numpy(X), torch.from_numpy(y), w, None,
                  prepared=prep)
    fitted = tl.predict_scores(p, torch.from_numpy(X))[0].numpy()
    assert (np.diff(fitted) >= -1e-6).all()
    # pool adjacent violators, the reference algorithm
    blocks = [[float(v), 1.0] for v in y]
    i = 0
    while i < len(blocks) - 1:
        if blocks[i][0] > blocks[i + 1][0]:
            m = (blocks[i][0] * blocks[i][1] + blocks[i + 1][0]
                 * blocks[i + 1][1]) / (blocks[i][1] + blocks[i + 1][1])
            blocks[i:i + 2] = [[m, blocks[i][1] + blocks[i + 1][1]]]
            i = max(i - 1, 0)
        else:
            i += 1
    pav = np.concatenate([[m] * int(c) for m, c in blocks])
    np.testing.assert_allclose(fitted, pav, atol=1e-5, rtol=0)


def test_interp_equals_jnp_interp():
    from spark_bagging_tpu_torch.models.isotonic import interp

    rng = np.random.default_rng(6)
    xp = np.sort(rng.standard_normal((3, 12)), axis=1).astype(np.float32)
    xp[1, 4] = xp[1, 5]  # a span of width 0
    fp = rng.standard_normal((3, 12)).astype(np.float32)
    x = np.concatenate([rng.standard_normal(50) * 2, xp[1, :6]]).astype(
        np.float32)
    got = interp(torch.from_numpy(x), torch.from_numpy(xp),
                 torch.from_numpy(fp)).numpy()
    for r in range(3):  # the same arithmetic: within an ulp or two
        np.testing.assert_allclose(
            got[r], np.asarray(jnp.interp(x, xp[r], fp[r])), rtol=0,
            atol=4 * np.finfo(np.float32).eps * np.abs(fp[r]).max())


@pytest.mark.parametrize("with_aux", [True, False])
def test_aft_matches_jax_with_the_aux_channel(with_aux):
    X, t, cens = _survival()
    kw = dict(max_iter=100)
    fit_kw = {"aux": cens} if with_aux else {}
    jf, tf = _fit_both(J.AFTSurvivalRegression(**kw),
                       T.AFTSurvivalRegression(**kw), X, t, **fit_kw)
    _assert_ensembles(jf, tf, AFT_TOL, X)
    probs = (0.1, 0.5, 0.9)
    q = tf.predict_quantiles(X, probs)
    assert q.shape == (len(X), 3) and (np.diff(q, axis=1) > 0).all()
    _close(q, jf.predict_quantiles(X, probs), AFT_TOL, "quantiles")


def test_aux_changes_the_fit_and_is_validated():
    X, t, cens = _survival()
    est = dict(n_estimators=4, seed=0)
    a = T.BaggingRegressor(T.AFTSurvivalRegression(max_iter=30),
                           device="cpu", **est).fit(X, t, aux=cens)
    b = T.BaggingRegressor(T.AFTSurvivalRegression(max_iter=30),
                           device="cpu", **est).fit(X, t)
    assert not torch.equal(a.ensemble_["beta"], b.ensemble_["beta"])
    with pytest.raises(ValueError, match="aux shape"):
        T.BaggingRegressor(T.AFTSurvivalRegression(), device="cpu").fit(
            X, t, aux=cens[:-1])
    with pytest.raises(ValueError, match="uses_aux"):
        T.BaggingRegressor(T.GeneralizedLinearRegression(),
                           device="cpu").fit(X, t, aux=cens)


def _stream_pair(aux_col):
    X, t, cens = _survival()
    Xa = np.insert(X, aux_col % (X.shape[1] + 1), cens, axis=1)
    return X, t, Xa


@pytest.mark.parametrize("aux_col", [2, -1])
def test_aft_stream_with_aux_col_matches_jax(aux_col):
    X, t, Xa = _stream_pair(aux_col)
    est = dict(n_estimators=4, seed=2, oob_score=True)
    kw = dict(n_epochs=2, steps_per_chunk=2, lr=0.05, aux_col=aux_col)
    jf = J.BaggingRegressor(J.AFTSurvivalRegression(), **est).fit_stream(
        JChunks(Xa, t, 96), **kw)
    tf = T.BaggingRegressor(T.AFTSurvivalRegression(), device="cpu",
                            **est).fit_stream(TChunks(Xa, t, 96),
                                              prefetch=0, **kw)
    assert tf.n_features_in_ == X.shape[1] == jf.n_features_in_
    for k, v in tf.ensemble_.items():
        _close(v.numpy(), jf.ensemble_[k], AFT_TOL, k)
    _close(tf.predict(X), jf.predict(X), AFT_TOL, "predict")
    assert abs(tf.oob_score_ - jf.oob_score_) <= AFT_TOL
    # the stream predicts drop the aux column of the fit's own source
    with pytest.warns(UserWarning, match="aux channel"):
        streamed = tf.predict_stream(TChunks(Xa, t, 96), prefetch=0)
    # chunks of 96 rows: the products round alike to an ulp
    np.testing.assert_allclose(streamed, tf.predict(X), atol=0, rtol=1e-6)
    assert tf.predict_stream((Xa, t), chunk_rows=96, prefetch=0,
                             drop_aux_col=True).shape == (len(t),)
    assert np.isfinite(tf.score_stream(TChunks(Xa, t, 96), prefetch=0,
                                       drop_aux_col=True))
    with pytest.raises(ValueError, match="features"):
        tf.predict_stream(TChunks(Xa, t, 96), prefetch=0,
                          drop_aux_col=False)


def test_stream_aux_col_is_validated_like_jax():
    X, t, Xa = _stream_pair(2)
    reg = T.BaggingRegressor(T.AFTSurvivalRegression(), n_estimators=2,
                             device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        reg.fit_stream((Xa, t), chunk_rows=100, aux_col=9, prefetch=0)
    with pytest.warns(UserWarning, match="aux_col=None"):
        reg.fit_stream((X, t), chunk_rows=100, prefetch=0)
    with pytest.raises(ValueError, match="not stream-fitted"):
        reg.predict_stream((X, t), chunk_rows=100, prefetch=0,
                           drop_aux_col=True)
    # an in-memory fit forgets a stream fit's aux column
    reg.fit_stream((Xa, t), chunk_rows=100, aux_col=2, prefetch=0)
    assert reg._stream_aux_col == 2
    reg.fit(X, t)
    assert reg._stream_aux_col is None


def test_split_aux_col_matches_jax():
    from spark_bagging_tpu.streaming import split_aux_col as jsplit

    Xa = np.arange(24, dtype=np.float32).reshape(4, 6)
    for col in (None, 0, 3, -1):
        got, want = split_aux_col(Xa, col), jsplit(Xa, col)
        np.testing.assert_array_equal(got[0], want[0])
        if col is None:
            assert got[1] is None and want[1] is None
        else:
            np.testing.assert_array_equal(got[1], want[1])


def test_glm_stream_matches_jax():
    X, y = _data()
    y = _target("poisson", y)
    est = dict(n_estimators=4, seed=1)
    kw = dict(n_epochs=2, steps_per_chunk=2, lr=0.05)
    jf = J.BaggingRegressor(J.GeneralizedLinearRegression(family="poisson"),
                            **est).fit_stream(JChunks(X, y, 128), **kw)
    tf = T.BaggingRegressor(T.GeneralizedLinearRegression(family="poisson"),
                            device="cpu", **est).fit_stream(
        TChunks(X, y, 128), prefetch=0, **kw)
    _close(tf.ensemble_["beta"].numpy(), jf.ensemble_["beta"], FM_TOL)
    _close(tf.predict(X), jf.predict(X), PRED_TOL)


@pytest.mark.parametrize("name", ["GeneralizedLinearRegression",
                                  "FMRegressor", "IsotonicRegression",
                                  "AFTSurvivalRegression"])
def test_from_jax_arrays_predicts_like_jax(name):
    X, y = _data()
    fit_kw = {}
    if name == "AFTSurvivalRegression":
        X, y, cens = _survival()
        fit_kw = {"aux": cens}
    kw = dict(max_iter=20) if name in ("FMRegressor",
                                       "AFTSurvivalRegression") else {}
    jf = J.BaggingRegressor(getattr(J, name)(**kw), **EST).fit(X, y, **fit_kw)
    tf = T.BaggingRegressor.from_jax_arrays(
        {k: np.asarray(v) for k, v in jf.ensemble_.items()},
        np.asarray(jf.subspaces_), n_features=jf.n_features_in_,
        base_learner=getattr(T, name)(**kw), device="cpu")
    _close(tf.predict(X), jf.predict(X), PRED_TOL, name)
    if name == "AFTSurvivalRegression":
        _close(tf.predict_quantiles(X), jf.predict_quantiles(X), PRED_TOL)


@pytest.mark.parametrize("name,kw", [
    ("GeneralizedLinearRegression", dict(family="binary")),
    ("GeneralizedLinearRegression", dict(link="probit")),
    ("GeneralizedLinearRegression", dict(family="poisson", link="logit")),
    ("GeneralizedLinearRegression", dict(family="tweedie",
                                         variance_power=2.5)),
    ("GeneralizedLinearRegression", dict(max_iter=0)),
    ("GeneralizedLinearRegression", dict(family="gaussian", link="log",
                                         init="pooled")),
    ("FMRegressor", dict(factor_size=0)),
    ("IsotonicRegression", dict(n_bins=1)),
    ("AFTSurvivalRegression", dict(max_iter=0)),
])
def test_rejects_what_jax_rejects(name, kw):
    with pytest.raises(ValueError):
        getattr(J, name)(**kw)
    with pytest.raises(ValueError):
        getattr(T, name)(**kw)


@pytest.mark.parametrize("name", ["GeneralizedLinearRegression",
                                  "FMRegressor", "IsotonicRegression",
                                  "AFTSurvivalRegression"])
def test_cost_models_and_flags_equal_jax(name):
    jl, tl = getattr(J, name)(), getattr(T, name)()
    for n, d in ((16_512, 8), (500, 7)):
        assert tl.flops_per_fit(n, d, 1) == jl.flops_per_fit(n, d, 1)
        assert tl.sgd_step_flops(n, d, 1) == jl.sgd_step_flops(n, d, 1)
        want = jl.fit_workset_bytes(n, d, 1)
        if want is not None and name != "GeneralizedLinearRegression":
            assert tl.fit_workset_bytes(n, d, 1) == want
        assert tl.fit_workset_bytes(n, d, 1) > 0
    assert (tl.streamable, tl.uses_aux) == (jl.streamable, jl.uses_aux)
    assert tl.get_params() == jl.get_params()


def test_quantiles_need_a_survival_learner():
    X, y = _data()
    tf = T.BaggingRegressor(device="cpu", n_estimators=2).fit(X, y)
    with pytest.raises(AttributeError, match="predict_quantiles"):
        tf.predict_quantiles(X)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        X, t, cens = _survival()
        a = T.BaggingRegressor(T.AFTSurvivalRegression(max_iter=5),
                               n_estimators=3, max_features=0.6,
                               chunk_size=2, device="cpu").fit(X, t, aux=cens)
        q = a.predict_quantiles(X, probs=[0.5])
    # the chunked mean over replicas of each replica's quantiles
    fn = a.base_learner_
    subs = a.subspaces_.long()
    per = torch.stack([fn.predict_quantiles(
        {k: v[r:r + 1] for k, v in a.ensemble_.items()},
        torch.from_numpy(X)[:, subs[r]][None], (0.5,))[0] for r in range(3)])
    np.testing.assert_allclose(q, per.mean(0).numpy(), atol=1e-6, rtol=1e-6)
