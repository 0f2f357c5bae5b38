"""The port's gradient-boosted trees against the JAX package.

Both packages fit the same bagged GBTs on the same numpy data (a few
hundred rows, 4 replicas, 4 rounds, depth 3, 16 bins): the bootstrap
weights, subspaces, round keys, row masks and class-tree keys are
bitwise equal (threefry), and the tree statistics are float moments
(h, h z, h z^2) summed in float32 in another order.

Tolerances (the ones float-moment forests are held to):
- split ``feature`` and ``threshold`` equal; ``gain``, ``leaf``, ``f0``
  and the loss curve within 1e-5 (relative to the largest entry where
  the entries are large); ``predict`` / ``predict_proba`` within 1e-5;
  ``feature_importances_`` within 1e-6.
- The exception is a tie: two candidate splits that partition a node's
  weighted rows alike score equally in exact arithmetic, so the last
  bits of float sums added in another order decide which is taken. Two
  shapes occur at these sizes: the same partition reached with its
  sides swapped (left sums against total-minus-left, off by an ulp),
  and a node whose weighted rows all carry one Newton target (a class-
  pure node of round 0), where every candidate scores as the parent.
  Where the packages pick different splits of equal gain (within the
  gain tolerance), that node, the nodes under it and their leaves are
  left out of the structural comparison (and their gains out of the
  importances compared), and at most MAX_TIE_SHARE of the nodes may
  be. A tie splits the weighted rows alike, so every
  replica's scores still agree within 1e-5 on the rows it trained on
  (bootstrap weight > 0), and the ensemble's on the rows every replica
  trained on; rows a replica left out may route to another leaf.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.utils import datasets as jdata  # noqa: E402
from spark_bagging_tpu.utils import metrics as jmetrics  # noqa: E402
from spark_bagging_tpu_torch.models import gbt as tgbt  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tdata  # noqa: E402
from spark_bagging_tpu_torch.utils import metrics as tmetrics  # noqa: E402

GBT = dict(n_rounds=4, max_depth=3, n_bins=16)
EST = dict(n_estimators=4, max_features=0.8, seed=0)
TOL = 1e-5
IMP_TOL = 1e-6
MAX_TIE_SHARE = 0.1
TASKS = ("binary", "multiclass", "regression")


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


def _task_data(task):
    if task == "regression":
        return tdata.make_regression(300, 6, seed=0)
    return tdata.make_classification(
        300, 6, 2 if task == "binary" else 3, seed=1, class_sep=0.8)


def _estimators(task):
    if task == "regression":
        return J.BaggingRegressor, T.BaggingRegressor, J.GBTRegressor, \
            T.GBTRegressor
    return J.BaggingClassifier, T.BaggingClassifier, J.GBTClassifier, \
        T.GBTClassifier


def _fit_both(task, gbt=None, est=None):
    X, y = _task_data(task)
    JE, TE, JL, TL = _estimators(task)
    gbt = {**GBT, **(gbt or {})}
    est = {**EST, **(est or {})}
    jf = JE(JL(**gbt), **est).fit(X, y)
    tf = TE(TL(**gbt), device="cpu", **est).fit(X, y)
    return X, y, jf, tf


@pytest.fixture(scope="module")
def fits():
    return {task: _fit_both(task) for task in TASKS}


def _predict(est, X):
    return (est.predict_proba(X) if hasattr(est, "predict_proba")
            else est.predict(X))


def _untied(jp, tp, depth):
    """(nodes, leaves) masks ``(R, trees·M)``, ``(R, trees, L)``: False at
    a tie (a node where the packages chose different splits of equal
    gain, see the module docstring), under one, and at the leaves below
    one."""
    M, L = 2**depth - 1, 2**depth
    R = jp["gain"].shape[0]
    scale = np.maximum(np.abs(jp["gain"]).max(axis=1, keepdims=True), 1.0)
    differ = ((jp["feature"] != tp["feature"])
              | (jp["threshold"] != tp["threshold"]))
    tie = differ & (np.abs(jp["gain"] - tp["gain"]) <= TOL * scale)
    bad = tie.reshape(R, -1, M).copy()
    for lv in range(1, depth):
        for r in range(2**lv):
            node, parent = 2**lv - 1 + r, 2**(lv - 1) - 1 + r // 2
            bad[..., node] |= bad[..., parent]
    leaf_parent = 2**(depth - 1) - 1 + np.arange(L) // 2
    return ~bad.reshape(R, -1), ~bad[..., leaf_parent]


def _assert_close(got, want, tol=TOL, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert got.shape == want.shape, err_msg
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{err_msg}: {err:.3g} > {tol} x {scale:.3g}"


def _importances(ens, subspaces, mask, n_features):
    """``feature_importances_`` from the gains at ``mask``: a tie's gain
    is credited to whichever feature a package picked."""
    feats = np.take_along_axis(np.asarray(subspaces),
                               _np(ens["feature"]).astype(np.int64), axis=1)
    imp = np.zeros(n_features)
    np.add.at(imp, feats[mask], _np(ens["gain"])[mask].astype(np.float64))
    return imp / imp.sum()


def assert_importances_match(jf, tf, depth):
    jp = {k: np.asarray(v) for k, v in jf.ensemble_.items()}
    tp = {k: _np(v) for k, v in tf.ensemble_.items()}
    nodes, _ = _untied(jp, tp, depth)
    if nodes.all():
        np.testing.assert_allclose(tf.feature_importances_,
                                   jf.feature_importances_, atol=IMP_TOL,
                                   rtol=0)
    full = np.ones_like(nodes)
    np.testing.assert_allclose(
        _importances(tf.ensemble_, tf.subspaces_, full, tf.n_features_in_),
        tf.feature_importances_, atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        _importances(tf.ensemble_, tf.subspaces_, nodes, tf.n_features_in_),
        _importances(jf.ensemble_, jf.subspaces_, nodes, jf.n_features_in_),
        atol=IMP_TOL, rtol=0)


def assert_gbts_match(jens, tens, depth):
    """The ensembles' splits, gains and leaves agree, ties aside (see
    the module docstring)."""
    jp = {k: np.asarray(v) for k, v in jens.items()}
    tp = {k: _np(v) for k, v in tens.items()}
    assert set(jp) == set(tp) == {"f0", "feature", "threshold", "gain", "leaf"}
    for k in jp:
        assert jp[k].shape == tp[k].shape, k
        assert jp[k].dtype == tp[k].dtype, k
    leaf_j = jp["leaf"].reshape(jp["leaf"].shape[0], -1, 2**depth)
    nodes, leaves = _untied(jp, tp, depth)
    assert nodes.mean() >= 1 - MAX_TIE_SHARE, nodes.mean()
    for k in ("feature", "threshold"):
        np.testing.assert_array_equal(tp[k][nodes], jp[k][nodes], err_msg=k)
    _assert_close(tp["gain"][nodes], jp["gain"][nodes], err_msg="gain")
    _assert_close(tp["leaf"].reshape(leaf_j.shape)[leaves], leaf_j[leaves],
                  err_msg="leaf")
    _assert_close(tp["f0"], jp["f0"], err_msg="f0")


def assert_predictions_match(jf, tf, X, y):
    """Each replica's scores on the rows it trained on, and the
    ensemble's on the rows every replica trained on, within TOL."""
    R = tf.n_estimators_
    inbag = np.stack([tf.replica_weights(i) > 0 for i in range(R)])
    jfn, jparams, jsubs = jf.replica_forward()
    tfn, tparams, tsubs = tf.replica_forward()
    jper = np.asarray(jfn(jparams, jsubs, jnp.asarray(X)))
    tper = tfn(tparams, tsubs, torch.from_numpy(X)).numpy()
    assert tper.shape == jper.shape
    for r in range(R):
        _assert_close(tper[r][inbag[r]], jper[r][inbag[r]],
                      err_msg=f"replica {r}")
    every = inbag.all(axis=0)
    assert every.sum() >= 20
    _assert_close(_predict(tf, X)[every], _predict(jf, X)[every],
                  err_msg="predict")
    assert abs(tf.score(X[every], y[every])
               - jf.score(X[every], y[every])) <= TOL


@pytest.mark.parametrize("task", TASKS)
def test_bagged_gbts_match_jax(fits, task):
    X, y, jf, tf = fits[task]
    np.testing.assert_array_equal(np.asarray(jf.subspaces_),
                                  tf.subspaces_.numpy())
    assert_gbts_match(jf.ensemble_, tf.ensemble_, GBT["max_depth"])
    assert_predictions_match(jf, tf, X, y)
    assert_importances_match(jf, tf, GBT["max_depth"])
    assert tf.fit_report_["model_flops_per_fit"] == \
        jf.fit_report_["model_flops_per_fit"]


def test_ensemble_layout_matches_jax(fits):
    R, rounds, M, L = 4, GBT["n_rounds"], 7, 8
    shapes = {
        "binary": dict(f0=(R,), feature=(R, rounds * M), leaf=(R, rounds, L)),
        "multiclass": dict(f0=(R, 3), feature=(R, rounds * 3 * M),
                           leaf=(R, rounds, 3, L)),
        "regression": dict(f0=(R,), feature=(R, rounds * M),
                           leaf=(R, rounds, L)),
    }
    for task, want in shapes.items():
        tens = fits[task][3].ensemble_
        for k, shape in want.items():
            assert tuple(tens[k].shape) == shape, (task, k)
        assert tens["feature"].dtype == torch.int32
        assert tens["threshold"].shape == tens["gain"].shape \
            == tens["feature"].shape


def test_binary_scores_are_zero_and_margin(fits):
    X, _, _, tf = fits["binary"]
    fn, params, subs = tf.replica_forward()
    learner = tf.base_learner_
    Xt = torch.from_numpy(X)
    scores = learner.predict_scores(params, Xt, cols=subs)
    assert tuple(scores.shape) == (4, len(X), 2)
    assert torch.equal(scores[..., 0], torch.zeros_like(scores[..., 0]))
    torch.testing.assert_close(fn(params, subs, Xt),
                               torch.softmax(scores, dim=-1))


def _learner_fits(task, gbt, n=300, R=3):
    """JAX's learner vmapped over R replicas and the port's on the same
    numpy weights and fit keys: (jax params, jax aux, port params, port
    aux, X)."""
    X, y = _task_data(task)
    JE, TE, JL, TL = _estimators(task)
    X, y = X[:n], y[:n]
    C = 1 if task == "regression" else int(y.max()) + 1
    w = np.random.default_rng(3).poisson(1.0, (R, n)).astype(np.float32)
    jl, tl = JL(**{**GBT, **gbt}), TL(**{**GBT, **gbt})
    jkeys = jax.random.split(jax.random.key(0), R)
    tkeys = prng.split(prng.key(0), R)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkeys)),
                                  tkeys.numpy())
    jX, jy = jnp.asarray(X), jnp.asarray(y)
    p0 = jl.init_params(None, X.shape[1], C)
    # jitted, as the JAX package's bagging runs it (one compile instead
    # of an eager dispatch per operation)
    jp, jaux = jax.jit(jax.vmap(
        lambda wr, k: jl.fit(p0, jX, jy, wr, k)))(jnp.asarray(w), jkeys)
    yt = torch.from_numpy(y) if task == "regression" \
        else torch.from_numpy(y).long()
    tp, taux = tl.fit(tl.init_params(tkeys, X.shape[1], C),
                      torch.from_numpy(X), yt, torch.from_numpy(w), tkeys)
    return jp, jaux, tp, taux, X


@pytest.mark.parametrize("task", TASKS)
def test_learner_loss_curve_matches_jax(task):
    jp, jaux, tp, taux, _ = _learner_fits(task, {})
    assert tuple(taux["loss_curve"].shape) == (3, GBT["n_rounds"])
    _assert_close(taux["loss_curve"].numpy(), np.asarray(jaux["loss_curve"]),
                  err_msg="loss_curve")
    _assert_close(taux["loss"].numpy(), np.asarray(jaux["loss"]),
                  err_msg="loss")
    # a boosted fit lowers its training loss round after round
    assert (np.diff(taux["loss_curve"].numpy(), axis=1) <= 1e-5).all()
    assert_gbts_match(jp, tp, GBT["max_depth"])


def test_subsample_row_masks_bitwise_and_fit(fits):
    n, R = 300, 3
    jl = J.GBTClassifier(subsample=0.7, **GBT)
    tl = T.GBTClassifier(subsample=0.7, **GBT)
    jkeys = jax.random.split(jax.random.key(5), R)
    tkeys = prng.split(prng.key(5), R)
    for m in (0, 3):
        want = jax.vmap(lambda k: jl._round_row_mask(
            jax.random.fold_in(k, m), n, None))(jkeys)
        got = tl._round_row_mask(prng.fold_in(tkeys, m), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.6 < float(got.mean()) < 0.8
    assert tl._round_row_mask(tkeys, n) is not None
    assert T.GBTClassifier()._round_row_mask(tkeys, n) is None
    for task in ("binary", "regression"):
        jp, jaux, tp, taux, _ = _learner_fits(task, {"subsample": 0.7})
        assert_gbts_match(jp, tp, GBT["max_depth"])
        _assert_close(taux["loss_curve"].numpy(),
                      np.asarray(jaux["loss_curve"]), err_msg=task)


def test_multiclass_class_keys_and_feature_subset_match_jax(monkeypatch):
    # the class trees' keys are fold_in(fold_in(key_m, 0x7EEE), c), in
    # (replica, class) order along the port's tree axis
    R, C, m = 3, 3, 2
    jkeys = jax.random.split(jax.random.key(0), R)
    tkeys = prng.split(prng.key(0), R)
    want = jax.vmap(lambda k: jax.vmap(lambda c: jax.random.key_data(
        jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(k, m),
                                              0x7EEE), c)))(jnp.arange(C)))(
        jkeys)
    seen = []
    grow = tgbt.GBTClassifier._grow

    def spy(self, X, S, prepared, keys=None, integral=False, axis_name=None):
        seen.append(keys)
        return grow(self, X, S, prepared, keys, integral, axis_name)

    monkeypatch.setattr(tgbt.GBTClassifier, "_grow", spy)
    jp, jaux, tp, taux, _ = _learner_fits("multiclass",
                                          {"feature_subset": "sqrt"})
    np.testing.assert_array_equal(seen[m].numpy(),
                                  np.asarray(want).reshape(R * C, 2))
    assert_gbts_match(jp, tp, GBT["max_depth"])
    _assert_close(taux["loss_curve"].numpy(), np.asarray(jaux["loss_curve"]),
                  err_msg="loss_curve")


@pytest.mark.parametrize("task", TASKS)
def test_fused_and_dense_split_search_grow_the_same_trees(task):
    X, y = _task_data(task)
    _, TE, _, TL = _estimators(task)
    ens = {impl: TE(TL(split_impl=impl, **GBT), device="cpu",
                    **EST).fit(X, y).ensemble_
           for impl in ("fused", "dense")}
    for k in ("feature", "threshold"):
        assert torch.equal(ens["fused"][k], ens["dense"][k]), k
    for k in ("gain", "leaf", "f0"):
        torch.testing.assert_close(ens["fused"][k], ens["dense"][k],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_from_jax_arrays_predicts_like_jax(fits, task):
    X, y, jf, _ = fits[task]
    port = T.BaggingClassifier.from_jax_arrays(
        {k: np.asarray(v) for k, v in jf.ensemble_.items()},
        np.asarray(jf.subspaces_), classes=np.asarray(jf.classes_),
        n_features=jf.n_features_in_, base_learner=T.GBTClassifier(**GBT),
        device="cpu")
    assert port.ensemble_["feature"].dtype == torch.int32
    _assert_close(port.predict_proba(X), jf.predict_proba(X),
                  err_msg="predict_proba")
    np.testing.assert_array_equal(port.predict(X), jf.predict(X))
    # the same gains: the same importances
    np.testing.assert_allclose(port.feature_importances_,
                               jf.feature_importances_, atol=1e-12, rtol=0)


def test_to_debug_string_matches_jax(fits):
    """Both packages' strings of the same trees' parameters (the port's
    fits: the strings depend on the parameters only)."""
    X, y = tdata.make_classification(300, 6, 3, seed=2)
    names = [f"x{i}" for i in range(6)]
    cases = [(J.DecisionTreeClassifier(max_depth=3, n_bins=16),
              T.DecisionTreeClassifier(max_depth=3, n_bins=16), X, y,
              T.BaggingClassifier),
             (J.DecisionTreeRegressor(max_depth=3, n_bins=16),
              T.DecisionTreeRegressor(max_depth=3, n_bins=16), X,
              X[:, 0] + (y == 1), T.BaggingRegressor)]
    for jl, tl, Xc, yc, TE in cases:
        tf = TE(tl, n_estimators=2, seed=0, device="cpu").fit(Xc, yc)
        for i in range(2):
            params = {k: np.asarray(v) for k, v in
                      tf.replica_params(i)[0].items()}
            want = jl.to_debug_string(params)
            assert tl.to_debug_string(params) == want
            assert tl.to_debug_string(params, names) == \
                jl.to_debug_string(params, names)
            assert want.startswith(type(jl).__name__)
    for task in ("binary", "multiclass"):
        _, _, jf, tf = fits[task]
        jl, tl = jf.base_learner_, tf.base_learner_
        for i in (0, 3):
            params = tf.replica_params(i)[0]
            want = jl.to_debug_string(params, names)
            assert tl.to_debug_string(params, names) == want
            assert ("(class 2)" in want) == (task == "multiclass")


def test_guards_raise_where_jax_raises():
    for kw in (dict(n_rounds=0), dict(lr=0.0), dict(lr=1.5),
               dict(subsample=0.0), dict(subsample=1.2)):
        with pytest.raises(ValueError):
            J.GBTClassifier(**kw)
        with pytest.raises(ValueError):
            T.GBTClassifier(**kw)
        with pytest.raises(ValueError):
            T.GBTRegressor(**kw)
    keys = prng.split(prng.key(0), 2)
    with pytest.raises(ValueError, match=">= 2 classes"):
        T.GBTClassifier().init_params(keys, 4, 1)
    X, y = _task_data("multiclass")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()
    w = torch.ones((2, len(y)))
    for gbt, C in ((dict(subsample=0.5), 2), (dict(subsample=0.5), 3),
                   (dict(feature_subset="sqrt"), 3)):
        tl = T.GBTClassifier(**gbt, **GBT)
        params = tl.init_params(keys, 6, C)
        with pytest.raises(ValueError, match="key"):
            tl.fit(params, Xt, yt.clamp_max(C - 1), w, None)
    with pytest.raises(ValueError, match="single class"):
        T.BaggingClassifier(T.GBTClassifier(), device="cpu").fit(
            X, np.zeros(len(y)))
    with pytest.raises(ValueError, match="regression learner"):
        T.BaggingClassifier(T.GBTRegressor(), device="cpu").fit(X, y)


def test_cost_models():
    for shape in ((800_000, 28, 2), (581_012, 54, 7), (400, 8, 3)):
        for jl, tl in ((J.GBTClassifier(), T.GBTClassifier()),
                       (J.GBTRegressor(n_rounds=7), T.GBTRegressor(n_rounds=7))):
            assert tl.flops_per_fit(*shape) == jl.flops_per_fit(*shape)
    b = [T.GBTClassifier().fit_workset_bytes(10_000, 28, C) for C in (2, 3, 7)]
    assert 0 < b[0] < b[1] < b[2]
    # a round grows C trees: C times the one tree's bytes and more
    tree = T.DecisionTreeRegressor(max_depth=5, n_bins=32).fit_workset_bytes(
        10_000, 28, 1)
    assert b[2] > 7 * tree
    assert T.GBTRegressor().fit_workset_bytes(10_000, 28, 1) == b[0]


def test_synthetic_higgs_and_rank_metrics_match_jax():
    for kw in (dict(n_rows=2000), dict(n_rows=500, seed=3, structure_seed=1)):
        Xj, yj = jdata.synthetic_higgs(**kw)
        Xt, yt = tdata.synthetic_higgs(**kw)
        np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)
        assert Xt.shape[1] == 28 and set(np.unique(yt)) == {0, 1}
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 1000)
    # rounded scores: long runs of ties
    s = np.round(rng.normal(size=1000) + 0.5 * y, 1)
    for labels in (y, 2 * y - 1, y.astype(bool)):
        assert tmetrics.roc_auc(labels, s) == jmetrics.roc_auc(labels, s)
        assert tmetrics.pr_auc(labels, s) == jmetrics.pr_auc(labels, s)
    assert tmetrics.roc_auc(np.ones(5), np.arange(5.0)) == 0.5
    assert tmetrics.pr_auc(np.zeros(5), np.arange(5.0)) == 0.0
    with pytest.raises(ValueError, match="binary"):
        tmetrics.roc_auc(y + 1, s)
    with pytest.raises(ValueError, match="binary"):
        tmetrics.pr_auc(y + 1, s)
