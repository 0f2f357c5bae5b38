"""Online updates (``online.OnlineUpdater``) in the port against the JAX
package's, and the update stream's key schedule.

- ``online_step_key`` and every step's Poisson(1) weights are bitwise
  JAX's (threefry).
- Three warm ``partial_fit`` steps of 100 fresh rows on an 8-replica
  bag, in both packages: the per-step OOB rows equal, the running
  ``oob_estimate()`` equal (regression: within 1e-6, the masked
  prediction sums add in another order), and the params within each
  learner's parity tolerance: logistic (damped Newton, the scaled-Gram
  path) ``W_TOL`` of tests/test_torch_logistic.py, max |dW| within 1e-4
  of max |W|; ridge ``BETA_TOL`` 1e-5 (tests/test_torch_linear.py),
  relative the same way; the MLP (tests/test_torch_mlp.py)
  ``predict_proba`` within ``MLP_TOL`` 1e-5 and its parameters within
  ``LONG_PARAM_TOL`` 2e-4, absolute: every step's fit starts a fresh
  Adam, whose first step is ``lr`` times the gradient's sign, so an
  element with a near-zero gradient turns a last-bit difference into a
  step difference of up to ``lr`` at every step (found 1.7e-5 of max
  |W1| with one thread).
  The classification data use ``class_sep=0.5``: each step refits on
  its 100 rows, and a separable step sends Newton's iterates toward
  infinity in both packages, where their last-bit differences grow
  without bound.
- ``warm=False`` replays the port's batch fit bit for bit.
- Every rejection has JAX's error type and message.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.online import OnlineUpdater as JaxUpdater  # noqa: E402
from spark_bagging_tpu.ops import bootstrap as jboot  # noqa: E402
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.online import OnlineUpdater  # noqa: E402
from spark_bagging_tpu_torch.ops import bootstrap as tboot  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import (  # noqa: E402
    make_classification,
    make_regression,
)

R, N_FIT, STEP, STEPS = 8, 300, 100, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_stream.py explains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 12345])
def test_online_step_key_bitwise_jax(seed):
    tk, jk = prng.key(seed), jax.random.key(seed)
    for step in (0, 1, 7, 2**31 + 5):
        got = tboot.online_step_key(tk, step).numpy().astype(np.uint32)
        want = _jax_key_data(jboot.online_step_key(jk, step))
        np.testing.assert_array_equal(got, want)


def test_online_step_weights_bitwise_jax():
    """A step's Poisson(1) row weights: the batch schedule under the
    step's key, replica by replica."""
    for step in (0, 3):
        tk = tboot.online_step_key(prng.key(0), step)
        jk = jboot.online_step_key(jax.random.key(0), step)
        got = tboot.bootstrap_weights(tk, torch.arange(R), STEP).numpy()
        want = np.stack([np.asarray(jboot.bootstrap_weights_one(
            jk, jax.numpy.int32(r), STEP, ratio=1.0, replacement=True))
            for r in range(R)])
        np.testing.assert_array_equal(got, want)


W_TOL = 1e-4
BETA_TOL = 1e-5
MLP_TOL = 1e-5
LONG_PARAM_TOL = 2e-4

LEARNERS = {
    # name: (learner factory, task, params tolerance, relative to max
    # |param| or absolute)
    "logistic": (lambda p: p.LogisticRegression(max_iter=3), "c",
                 (W_TOL, "relative")),
    "ridge": (lambda p: p.LinearRegression(l2=1e-3), "r",
              (BETA_TOL, "relative")),
    "mlp": (lambda p: p.MLPClassifier(hidden=8, max_iter=5), "c",
            (LONG_PARAM_TOL, "absolute")),
}


def _data(task: str):
    n = N_FIT + STEPS * STEP
    if task == "r":
        return make_regression(n, 6, seed=1)
    return make_classification(n, 6, 3, seed=1, class_sep=0.5)


def _pair(name: str, **kw):
    make, task, _ = LEARNERS[name]
    X, y = _data(task)
    est = {"c": "BaggingClassifier", "r": "BaggingRegressor"}[task]
    tc = getattr(T, est)(make(T), n_estimators=R, seed=0, device="cpu",
                         **kw).fit(X[:N_FIT], y[:N_FIT])
    jc = getattr(J, est)(make(J), n_estimators=R, seed=0,
                         **kw).fit(X[:N_FIT], y[:N_FIT])
    return X, y, tc, jc


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_warm_steps_match_jax(name):
    X, y, tc, jc = _pair(name)
    tol, kind = LEARNERS[name][2]
    tu, ju = OnlineUpdater(tc), JaxUpdater(jc)
    for s in range(STEPS):
        sl = slice(N_FIT + s * STEP, N_FIT + (s + 1) * STEP)
        rt, rj = tu.partial_fit(X[sl], y[sl]), ju.partial_fit(X[sl], y[sl])
        assert rt["step"] == rj["step"] == s
        assert rt["oob_rows"] == rj["oob_rows"] > 0
        if LEARNERS[name][1] == "c":
            assert rt["oob_estimate"] == rj["oob_estimate"]
        else:
            assert abs(rt["oob_estimate"] - rj["oob_estimate"]) <= 1e-6
    assert tu.steps == ju.steps and tu.rows_seen == ju.rows_seen
    assert tu.oob_rows == ju.oob_rows
    ct, cj = tu.to_estimator(), ju.to_estimator()
    for k, v in ct.ensemble_.items():
        want = np.asarray(cj.ensemble_[k])
        err = np.abs(v.numpy() - want).max()
        if kind == "relative":
            err /= np.abs(want).max()
        assert err <= tol, f"{name} {k}: {kind} error {err:.3g} (> {tol})"
    if name == "mlp":
        np.testing.assert_allclose(ct.predict_proba(X[:N_FIT]),
                                   cj.predict_proba(X[:N_FIT]),
                                   atol=MLP_TOL, rtol=0)
    assert ct.online_steps_ == cj.online_steps_ == STEPS
    assert ct.online_oob_estimate_ == tu.oob_estimate()


def test_warm_steps_keep_the_fitted_estimator_and_publish():
    X, y, tc, _ = _pair("logistic", oob_score=True)
    W0 = tc.ensemble_["W"].clone()
    tu = OnlineUpdater(tc)
    tu.partial_fit(X[N_FIT:], y[N_FIT:])
    assert torch.equal(tc.ensemble_["W"], W0)  # the incumbent is untouched
    cand = tu.to_estimator()
    assert not hasattr(cand, "oob_score_") and hasattr(tc, "oob_score_")
    assert not torch.equal(cand.ensemble_["W"], W0)
    from spark_bagging_tpu_torch.serving import ModelRegistry

    reg = ModelRegistry()
    reg.register("m", tc)
    reg.swap("m", cand)
    np.testing.assert_allclose(reg.executor("m").forward(X[:20]),
                               cand.predict_proba(X[:20]), atol=1e-6, rtol=0)


def test_ones_mode_matches_jax():
    X, y, tc, jc = _pair("ridge")
    tu = OnlineUpdater(tc, weight_mode="ones", seed=3)
    ju = JaxUpdater(jc, weight_mode="ones", seed=3)
    sl = slice(N_FIT, N_FIT + STEP)
    assert tu.partial_fit(X[sl], y[sl]) == ju.partial_fit(X[sl], y[sl])
    np.testing.assert_allclose(tu.to_estimator().ensemble_["beta"].numpy(),
                               np.asarray(ju.to_estimator().ensemble_["beta"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["logistic", "ridge"])
def test_cold_start_replays_the_batch_fit_bitwise(name):
    """``warm=False``: the first step over the fit's own rows is the
    batch fit, bit for bit (a ``bootstrap=False`` bag, as the JAX
    package's anchor)."""
    X, y, tc, _ = _pair(name, bootstrap=False)
    tu = OnlineUpdater(tc, warm=False)
    with pytest.raises(RuntimeError, match="no params yet"):
        tu.to_estimator()
    assert tu.partial_fit(X[:N_FIT], y[:N_FIT])["oob_rows"] == 0
    replay = tu.to_estimator()
    for k, v in tc.ensemble_.items():
        assert torch.equal(replay.ensemble_[k], v), k
    assert torch.equal(replay.subspaces_, tc.subspaces_)


def test_online_telemetry_series():
    X, y, tc, _ = _pair("logistic")
    reg = telemetry.registry()
    before = reg.counter("sbt_online_examples_total",
                         {"model": "m"}).value
    OnlineUpdater(tc, labels={"model": "m"}).partial_fit(X[N_FIT:],
                                                         y[N_FIT:])
    after = reg.counter("sbt_online_examples_total", {"model": "m"}).value
    assert after - before == STEPS * STEP


def _both_raise(make_t, make_j, exc=ValueError):
    with pytest.raises(exc) as et:
        make_t()
    with pytest.raises(exc) as ej:
        make_j()
    assert str(et.value) == str(ej.value)


def test_rejections_match_jax():
    X, y = make_classification(120, 4, 2, seed=0)
    Xr, yr = make_regression(120, 4, seed=0)
    # trees: structure search, not refinable
    tc = T.BaggingClassifier(T.DecisionTreeClassifier(max_depth=2),
                             n_estimators=2, device="cpu").fit(X, y)
    jc = J.BaggingClassifier(J.DecisionTreeClassifier(max_depth=2),
                             n_estimators=2).fit(X, y)
    _both_raise(lambda: OnlineUpdater(tc), lambda: JaxUpdater(jc))
    # an aux-channel learner
    aux = (np.arange(120) % 3 > 0).astype(np.float32)
    yt = np.abs(yr) + 0.5
    tr = T.BaggingRegressor(T.AFTSurvivalRegression(max_iter=3),
                            n_estimators=2, device="cpu").fit(Xr, yt, aux=aux)
    jr = J.BaggingRegressor(J.AFTSurvivalRegression(max_iter=3),
                            n_estimators=2).fit(Xr, yt, aux=aux)
    _both_raise(lambda: OnlineUpdater(tr), lambda: JaxUpdater(jr))
    # stream-fitted
    ts = T.BaggingClassifier(T.LogisticRegression(), n_estimators=2,
                             device="cpu").fit_stream((X, y), chunk_rows=60)
    js = J.BaggingClassifier(J.LogisticRegression(),
                             n_estimators=2).fit_stream((X, y), chunk_rows=60)
    _both_raise(lambda: OnlineUpdater(ts), lambda: JaxUpdater(js))
    # a mesh, and a bad weight mode
    tl = T.BaggingClassifier(T.LogisticRegression(max_iter=2), n_estimators=2,
                             device="cpu").fit(X, y)
    jl = J.BaggingClassifier(J.LogisticRegression(max_iter=2),
                             n_estimators=2).fit(X, y)
    _both_raise(lambda: OnlineUpdater(tl, weight_mode="bad"),
                lambda: JaxUpdater(jl, weight_mode="bad"))
    tl.mesh, jl.mesh = "a mesh", "a mesh"
    try:
        _both_raise(lambda: OnlineUpdater(tl), lambda: JaxUpdater(jl))
    finally:
        tl.mesh, jl.mesh = None, None
    # labels outside the fitted class set, a wrong width
    tu, ju = OnlineUpdater(tl), JaxUpdater(jl)
    _both_raise(lambda: tu.partial_fit(X[:5], np.full(5, 7)),
                lambda: ju.partial_fit(X[:5], np.full(5, 7)))
    _both_raise(lambda: tu.partial_fit(X[:5, :3], y[:5]),
                lambda: ju.partial_fit(X[:5, :3], y[:5]))
