"""Mesh fits, predicts and OOB of the port (``parallel/sharded.py``)
against the JAX package's on its 8-device CPU mesh.

The port's mesh is ``[torch.device("cpu")] * 8``, each shard a thread.
What is bitwise and what is held to a tolerance:

- a replica mesh draws every replica's weights and subspace from
  ``(seed, replica id)``: subspaces and ``replica_weights`` bitwise
  JAX's; coefficients within ``W_TOL`` (relative to max |W|) and
  probabilities within ``PROBA_ATOL``, the port's logistic tolerances
  (tests/test_torch_bagging.py);
- a data mesh draws each shard's rows from ``fold_in(key, shard)``:
  those draws are bitwise JAX's; with ``bootstrap=False`` every weight is
  1 and the data-parallel Newton fit is the single-device fit within
  ``1e-5``, as the JAX package's own test holds it;
- Gini trees on a data mesh sum integer tables, so they are bitwise
  JAX's data-sharded trees (leaf log-probabilities within 2 ulps, the
  trees' usual tolerance);
- OOB on data and replica meshes equals JAX's ``sharded_oob_scores``.

The data is breast cancer (569 x 30, standardized) and the diabetes
regression set, at most 16 replicas.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from sklearn.datasets import load_breast_cancer, load_diabetes  # noqa: E402
from sklearn.preprocessing import StandardScaler  # noqa: E402

import jax  # noqa: E402
import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.ops.bootstrap import (  # noqa: E402
    bootstrap_weights_one as jbootstrap_weights_one,
)
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.ensemble import _row_key  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights  # noqa: E402
from spark_bagging_tpu_torch.parallel import compat  # noqa: E402
from spark_bagging_tpu_torch.parallel.compat import P  # noqa: E402

W_TOL = 1e-4
PROBA_ATOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the mesh's eight shard threads are the
    parallelism here, and xdist workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def breast_cancer():
    X, y = load_breast_cancer(return_X_y=True)
    return StandardScaler().fit_transform(X).astype(np.float32), y


@pytest.fixture(scope="module")
def diabetes():
    X, y = load_diabetes(return_X_y=True)
    return (StandardScaler().fit_transform(X).astype(np.float32),
            y.astype(np.float32))


def tmesh(data=1, replica=None):
    return T.make_mesh(data, replica, devices=CPU8)


def jmesh(data=1, replica=None):
    return J.make_mesh(data, replica)


def gauge_free(W):
    """The part of multinomial W that softmax sees (a per-feature
    constant across classes changes nothing)."""
    W = np.asarray(W)
    return W - W.mean(-1, keepdims=True)


def assert_w_close(got, want, tol=W_TOL):
    got, want = gauge_free(got), gauge_free(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max |dW| is {err:.3g} of max |W| (> {tol})"


@pytest.fixture(scope="module")
def replica_fits(breast_cancer):
    X, y = breast_cancer
    kw = dict(n_estimators=16, seed=3, max_features=0.8, oob_score=True)
    lr = dict(max_iter=4)
    return dict(
        tm=T.BaggingClassifier(T.LogisticRegression(**lr), mesh=tmesh(),
                               device="cpu", **kw).fit(X, y),
        ts=T.BaggingClassifier(T.LogisticRegression(**lr), device="cpu",
                               **kw).fit(X, y),
        jm=J.BaggingClassifier(J.LogisticRegression(**lr), mesh=jmesh(),
                               **kw).fit(X, y),
    )


def test_replica_mesh_matches_jax_and_the_single_device_fit(
        replica_fits, breast_cancer):
    X, _ = breast_cancer
    tm, ts, jm = replica_fits["tm"], replica_fits["ts"], replica_fits["jm"]
    np.testing.assert_array_equal(tm.subspaces_.numpy(),
                                  np.asarray(jm.subspaces_))
    np.testing.assert_array_equal(tm.subspaces_.numpy(), ts.subspaces_.numpy())
    for i in (0, 7, 15):
        np.testing.assert_array_equal(tm.replica_weights(i),
                                      jm.replica_weights(i))
    assert_w_close(tm.ensemble_["W"].numpy(), np.asarray(jm.ensemble_["W"]))
    assert_w_close(tm.ensemble_["W"].numpy(), ts.ensemble_["W"].numpy())
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)
    np.testing.assert_allclose(tm.predict_proba(X), ts.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)
    assert tm.fit_report_["n_devices"] == 8


def test_oob_on_replica_mesh_matches_jax(replica_fits):
    tm, jm = replica_fits["tm"], replica_fits["jm"]
    np.testing.assert_allclose(tm.oob_decision_function_,
                               jm.oob_decision_function_, atol=0)
    assert tm.oob_score_ == jm.oob_score_


def test_data_mesh_draws_are_jax_fold_in_draws():
    """Each data shard draws its rows' weights from ``fold_in(key,
    shard)``, bitwise JAX's draw for that shard, replica by replica."""
    n_local, ids = 37, torch.arange(6)
    mesh = tmesh(8)

    def body(k):
        return bootstrap_weights(_row_key(k, "data"), ids, n_local)[None]

    got = compat.shard_map(body, mesh=mesh, in_specs=(P(),),
                           out_specs=P("data"))(prng.key(11))
    jkey = jax.random.key(11)
    for s in range(8):
        sk = jax.random.fold_in(jkey, s)
        want = np.stack([np.asarray(jbootstrap_weights_one(sk, r, n_local))
                         for r in range(6)])
        np.testing.assert_array_equal(got[s].numpy(), want)


def test_data_mesh_exact_with_deterministic_weights(breast_cancer):
    """``bootstrap=False, max_samples=1.0``: every weight is 1, so the
    data-parallel Newton fit is the single-device fit, and JAX's."""
    X, y = breast_cancer
    n = (len(y) // 8) * 8
    X, y = X[:n], y[:n]
    kw = dict(n_estimators=8, bootstrap=False, max_samples=1.0, seed=0)
    a = T.BaggingClassifier(mesh=tmesh(8), device="cpu", **kw).fit(X, y)
    b = T.BaggingClassifier(device="cpu", **kw).fit(X, y)
    j = J.BaggingClassifier(mesh=jmesh(8), **kw).fit(X, y)
    assert a.fit_report_["loss_mean"] == pytest.approx(
        b.fit_report_["loss_mean"], rel=1e-5)
    np.testing.assert_allclose(a.predict_proba(X), b.predict_proba(X),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(a.predict_proba(X), j.predict_proba(X),
                               atol=1e-5, rtol=0)


def test_2d_mesh_classifier_matches_jax(breast_cancer):
    """A (2, 4) mesh with padding (569 rows): per-shard draws, padded
    rows at zero weight, the data-axis Newton sums, replica-axis votes."""
    X, y = breast_cancer
    kw = dict(n_estimators=8, seed=1, max_features=0.8)
    t = T.BaggingClassifier(T.LogisticRegression(max_iter=4),
                            mesh=tmesh(2), device="cpu", **kw).fit(X, y)
    j = J.BaggingClassifier(J.LogisticRegression(max_iter=4),
                            mesh=jmesh(2), **kw).fit(X, y)
    np.testing.assert_array_equal(t.subspaces_.numpy(),
                                  np.asarray(j.subspaces_))
    assert_w_close(t.ensemble_["W"].numpy(), np.asarray(j.ensemble_["W"]))
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)
    assert t.score(X, y) > 0.95
    with pytest.raises(ValueError, match="globally replayable"):
        t.replica_weights(0)


def test_2d_mesh_ridge_matches_jax(diabetes):
    X, y = diabetes
    kw = dict(n_estimators=8, seed=2, oob_score=True)
    t = T.BaggingRegressor(mesh=tmesh(2), device="cpu", **kw).fit(X, y)
    j = J.BaggingRegressor(mesh=jmesh(2), **kw).fit(X, y)
    beta_t, beta_j = t.ensemble_["beta"].numpy(), np.asarray(j.ensemble_["beta"])
    np.testing.assert_allclose(beta_t, beta_j,
                               atol=1e-4 * np.abs(beta_j).max(), rtol=0)
    np.testing.assert_allclose(t.predict(X), j.predict(X),
                               atol=1e-4 * np.abs(y).max(), rtol=0)
    assert t.oob_score_ == pytest.approx(j.oob_score_, abs=1e-5)


@pytest.mark.parametrize("data", [8, 2])
def test_gini_trees_on_a_data_mesh_are_bitwise_jax(breast_cancer, data):
    """Per-shard quantile edges averaged in shard order, every level's
    integer table and the leaf counts summed over the shards: the
    trees are JAX's data-sharded trees bit for bit, and so are the OOB
    votes that regenerate each shard's draws."""
    X, y = breast_cancer
    kw = dict(n_estimators=8, seed=4, max_features=0.7, oob_score=True)
    tree = dict(max_depth=3, n_bins=16)
    t = T.BaggingClassifier(T.DecisionTreeClassifier(**tree),
                            mesh=tmesh(data), device="cpu", **kw).fit(X, y)
    j = J.BaggingClassifier(J.DecisionTreeClassifier(**tree),
                            mesh=jmesh(data), **kw).fit(X, y)
    for k in ("feature", "threshold", "gain"):
        np.testing.assert_array_equal(t.ensemble_[k].numpy(),
                                      np.asarray(j.ensemble_[k]), err_msg=k)
    lt, lj = t.ensemble_["leaf_logp"].numpy(), np.asarray(j.ensemble_["leaf_logp"])
    np.testing.assert_array_max_ulp(lt, lj, maxulp=2)
    np.testing.assert_array_equal(t.oob_decision_function_,
                                  j.oob_decision_function_)
    assert t.oob_score_ == j.oob_score_


def test_oob_on_a_data_mesh_matches_jax_sharded_oob(breast_cancer):
    """The estimator's OOB on a (8, 1) mesh against JAX's
    ``sharded_oob_scores`` over the same (JAX-fitted) weights: the
    per-shard masks are the same draws, so the vote counts are equal."""
    from spark_bagging_tpu.parallel.sharded import (
        pad_rows_X as jpad,
        sharded_oob_scores as jsharded_oob,
    )
    X, y = breast_cancer
    j = J.BaggingClassifier(J.LogisticRegression(max_iter=3),
                            mesh=jmesh(8), n_estimators=8, seed=6).fit(X, y)
    t = T.BaggingClassifier.from_jax_arrays(
        {"W": np.asarray(j.ensemble_["W"])}, np.asarray(j.subspaces_),
        classes=j.classes_, n_features=X.shape[1],
        base_learner=T.LogisticRegression(max_iter=3), device="cpu")
    t.mesh = tmesh(8)
    t._fit_key, t._fit_sampling = prng.key(6), (1.0, True)
    tc, tv = t._oob_scores(torch.as_tensor(X), 2)
    jc, jv = jsharded_oob(
        j._fitted_learner, j.mesh, j.ensemble_, j.subspaces_,
        jpad(X, 8), j._fit_key, 8, n_classes=2)
    np.testing.assert_array_equal(tv, np.asarray(jv)[:len(y)])
    np.testing.assert_array_equal(tc, np.asarray(jc)[:len(y)])


def test_hard_vote_on_a_mesh_matches_jax(breast_cancer):
    X, y = breast_cancer
    kw = dict(n_estimators=16, voting="hard", seed=5)
    tree = dict(max_depth=3, n_bins=16)
    t = T.BaggingClassifier(T.DecisionTreeClassifier(**tree), mesh=tmesh(),
                            device="cpu", **kw).fit(X, y)
    j = J.BaggingClassifier(J.DecisionTreeClassifier(**tree), mesh=jmesh(),
                            **kw).fit(X, y)
    np.testing.assert_array_max_ulp(t.predict_proba(X), j.predict_proba(X),
                                    maxulp=1)
    assert t.score(X, y) == j.score(X, y) > 0.95


def test_shardmap_trace_counts_equal_jax(breast_cancer):
    """The same mesh calls count the same ``sbt_shardmap_traces_total``
    series (kind and mesh labels) in both packages."""
    X, y = breast_cancer
    Xs, ys = X[:96], y[:96]

    def series(tel):
        return sorted((s["labels"]["kind"], s["labels"]["mesh"], s["value"])
                      for s in tel.registry().snapshot()
                      if s["name"] == "sbt_shardmap_traces_total")

    for tel in (telemetry, jtelemetry):
        tel.reset()
        tel.enable()
    for mod, mk in ((T, tmesh), (J, jmesh)):
        extra = {"device": "cpu"} if mod is T else {}
        c = mod.BaggingClassifier(n_estimators=8, seed=0, oob_score=True,
                                  mesh=mk(2), **extra).fit(Xs, ys)
        c.predict_proba(Xs)
        r = mod.BaggingRegressor(mod.DecisionTreeRegressor(max_depth=2),
                                 n_estimators=8, mesh=mk(), **extra).fit(
            Xs, ys.astype(np.float32))
        r.predict(Xs)
    assert series(telemetry) == series(jtelemetry)
    assert ("fit", "2x4", 1.0) in series(telemetry)


def test_mesh_refusals(breast_cancer, tmp_path, monkeypatch):
    """What a mesh does not do, or not yet: serving handles of a
    mesh-fitted estimator and quantiles (as in JAX), an indivisible
    replica axis, a warm start across a changed mesh, OOB over a
    data-sharded tree stream (as in JAX), and ``oob_score`` with
    ``fit_stream`` on a multi-process mesh (as in JAX; the 2-process
    runs are tests/test_torch_multihost.py). What it does since every family took
    the data axis: the GBT, MLP, SVM and naive Bayes fits on a data mesh
    (``bootstrap=False``) are the single-device fits (the GBT's under
    the mesh's averaged edges), and ``fit_stream`` runs on a mesh."""
    X, y = breast_cancer
    Xs, ys = X[:64], y[:64]
    exact = dict(n_estimators=2, bootstrap=False, max_samples=1.0)
    for learner in (T.GBTClassifier(n_rounds=2, max_depth=2),
                    T.MLPClassifier(hidden=4, max_iter=20), T.LinearSVC(),
                    T.GaussianNB()):
        on_mesh = T.BaggingClassifier(learner, mesh=tmesh(8), device="cpu",
                                      **exact).fit(Xs, ys)
        if isinstance(learner, T.GBTClassifier):
            edges = compat.shard_map(
                lambda Xd: learner.prepare(Xd, axis_name="data")["edges"],
                mesh=tmesh(8), in_specs=(P("data", None),),
                out_specs=P())(torch.from_numpy(Xs))
            monkeypatch.setattr(T.GBTClassifier, "prepare",
                                lambda self, Xp, **_: self._binned(Xp, edges))
        single = T.BaggingClassifier(learner, device="cpu",
                                     **exact).fit(Xs, ys)
        monkeypatch.undo()
        np.testing.assert_allclose(on_mesh.predict_proba(Xs),
                                   single.predict_proba(Xs), atol=1e-5,
                                   err_msg=type(learner).__name__)
    # the replica axis needs no learner plumbing: every family runs
    nb = T.BaggingClassifier(T.GaussianNB(), n_estimators=8, mesh=tmesh(),
                             device="cpu").fit(Xs, ys)
    nb_single = T.BaggingClassifier(T.GaussianNB(), n_estimators=8,
                                    device="cpu").fit(Xs, ys)
    np.testing.assert_allclose(nb.predict_proba(Xs),
                               nb_single.predict_proba(Xs), atol=1e-6)
    # a stream on a replica mesh draws the single-device stream's weights
    streamed = T.BaggingClassifier(n_estimators=8, mesh=tmesh(),
                                   device="cpu").fit_stream((Xs, ys))
    streamed_single = T.BaggingClassifier(n_estimators=8,
                                          device="cpu").fit_stream((Xs, ys))
    np.testing.assert_allclose(streamed.predict_proba(Xs),
                               streamed_single.predict_proba(Xs), atol=1e-5)
    with pytest.raises(ValueError, match="data-sharded tree stream"):
        T.BaggingClassifier(T.DecisionTreeClassifier(max_depth=2),
                            n_estimators=8, oob_score=True, mesh=tmesh(2),
                            device="cpu").fit_stream((Xs, ys))
    # more than one process: initialize_distributed is exported, and
    # with no arguments and no launcher environment it is a no-op
    assert T.parallel.initialize_distributed is (
        T.parallel.distributed.initialize_distributed)
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert T.parallel.initialize_distributed() == 1
    with pytest.raises(ValueError, match="single-device serving handle"):
        nb.aggregated_forward()
    with pytest.raises(ValueError, match="single-device serving handle"):
        nb.replica_forward()
    with pytest.raises(ValueError, match="divisible"):
        T.BaggingClassifier(n_estimators=10, mesh=tmesh(),
                            device="cpu").fit(Xs, ys)
    aft = T.BaggingRegressor(T.AFTSurvivalRegression(max_iter=5),
                             n_estimators=8, mesh=tmesh(),
                             device="cpu").fit(
        Xs, np.abs(ys.astype(np.float32)) + 1.0,
        aux=np.ones(64, np.float32))
    with pytest.raises(ValueError, match="single-device"):
        aft.predict_quantiles(Xs)
    grow = T.BaggingClassifier(n_estimators=8, warm_start=True,
                               mesh=tmesh(), device="cpu").fit(Xs, ys)
    grow.set_params(n_estimators=16, mesh=tmesh(2))
    with pytest.raises(ValueError, match="original mesh layout"):
        grow.fit(Xs, ys)


def test_warm_start_and_load_on_a_mesh(breast_cancer, tmp_path):
    """A mesh-fitted bag grows 8 -> 16 on its mesh as the cold 16-replica
    mesh fit (weights bitwise, probabilities within tolerance); saved, it
    loads without a mesh (single-device serving) or onto one."""
    X, y = breast_cancer
    Xs, ys = X[:200], y[:200]
    kw = dict(seed=8, mesh=tmesh(2), device="cpu")
    grown = T.BaggingClassifier(T.LogisticRegression(max_iter=3),
                                n_estimators=8, warm_start=True, **kw).fit(Xs, ys)
    grown.set_params(n_estimators=16).fit(Xs, ys)
    cold = T.BaggingClassifier(T.LogisticRegression(max_iter=3),
                               n_estimators=16, **kw).fit(Xs, ys)
    assert_w_close(grown.ensemble_["W"].numpy(), cold.ensemble_["W"].numpy())
    np.testing.assert_allclose(grown.predict_proba(Xs),
                               cold.predict_proba(Xs), atol=PROBA_ATOL)
    path = str(tmp_path / "m")
    cold.save(path)
    single = T.load_model(path, device="cpu")
    assert single.mesh is None
    np.testing.assert_allclose(single.predict_proba(Xs),
                               cold.predict_proba(Xs), atol=PROBA_ATOL)
    meshed = T.BaggingClassifier.load(path, mesh=tmesh())
    np.testing.assert_allclose(meshed.predict_proba(Xs),
                               cold.predict_proba(Xs), atol=PROBA_ATOL)
    with pytest.raises(ValueError, match="globally replayable|in-memory"):
        single.replica_weights(0)
