"""The port's out-of-core fit (streaming.py, the estimators' stream
surfaces, utils/io.py, utils/prefetch.py) against the JAX package.

Both packages stream the same numpy chunks: the chunk sources yield
bitwise equal chunks, and every chunk's replica weights
(``fold_in(fold_in(key, 0xC4C), c)``, times the validity mask) are
bitwise equal, so a padded tail row weighs 0 on both sides.

Tolerances: streamed SGD fits (3 chunks, the last padded, 2 epochs, 2
Adam steps a chunk: 12 steps) agree with JAX within MLP_TOL (1e-5) on
parameters, losses, predictions and OOB decision values; found at most
4.8e-7. The products sum in another order and Adam's normalized steps
carry the difference forward, so the bound leaves a factor of ~20 (the
in-memory MLP tests hold the same bound, tests/test_torch_mlp.py). At
the stream chip_smoke's ``mlp_device_check`` holds the card to (16
replicas, 8 chunks of 5,000 rows, 2 epochs: 32 steps) probabilities
stay within MLP_TOL (found 1.3e-6) and parameters within
LONG_PARAM_TOL (2e-4; found up to 1.0e-4 over seeds 0-3 with torch's
default threads, 3.0e-5 with the one thread these tests use: Adam
turns a last-bit difference of a near-zero gradient element into a
step difference of up to lr, as tests/test_torch_mlp.py explains, so
the summation order the thread count picks moves the found value).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import streaming as jstream  # noqa: E402
from spark_bagging_tpu.models import mlp as jmlp  # noqa: E402
from spark_bagging_tpu.ops import bootstrap as jboot  # noqa: E402
from spark_bagging_tpu.utils import datasets as jdata  # noqa: E402
from spark_bagging_tpu.utils import io as jio  # noqa: E402
from spark_bagging_tpu_torch import streaming as tstream  # noqa: E402
from spark_bagging_tpu_torch import tree_stream as ttree_stream  # noqa: E402
from spark_bagging_tpu_torch.ops import bootstrap as tboot  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tdata  # noqa: E402
from spark_bagging_tpu_torch.utils import io as tio  # noqa: E402
from spark_bagging_tpu_torch.utils.prefetch import PrefetchChunks  # noqa: E402

MLP_TOL = 1e-5
LONG_PARAM_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU fits here take one intra-op thread: under xdist each
    worker's default pool takes every core of the host and the workers'
    pools spin against one another (a 4 s test took 60 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# 500 rows in chunks of 200: two full chunks and a tail of 100 padded rows
N, CHUNK = 500, 200
FIT = dict(n_epochs=2, steps_per_chunk=2, lr=0.05, prefetch=0)


def _chunks(source):
    return [(X.copy(), y.copy(), n) for X, y, n in source.chunks()]


def _same_chunks(a, b):
    assert len(a) == len(b)
    for (Xa, ya, na), (Xb, yb, nb) in zip(a, b):
        assert na == nb
        np.testing.assert_array_equal(Xa, Xb)
        np.testing.assert_array_equal(ya, yb)


def test_chunk_sources_yield_jax_chunks_bitwise():
    X, y = tdata.make_classification(N, 6, 3, seed=0)
    want = _chunks(jio.ArrayChunks(X, y, CHUNK))
    assert [n for _, _, n in want] == [200, 200, 100]
    _same_chunks(want, _chunks(tio.ArrayChunks(X, y, CHUNK)))
    _same_chunks(want, _chunks(PrefetchChunks(tio.ArrayChunks(X, y, CHUNK))))
    _same_chunks(want, _chunks(tio.as_chunk_source((X, y), CHUNK)))
    _same_chunks(want[1:], [(a.copy(), b.copy(), n) for a, b, n in
                            tio.ArrayChunks(X, y, CHUNK).chunks_from(1)])
    _same_chunks(_chunks(jio.DropColumnChunks(jio.ArrayChunks(X, y, CHUNK),
                                              -1)),
                 _chunks(tio.DropColumnChunks(tio.ArrayChunks(X, y, CHUNK),
                                              -1)))
    j = jio.SyntheticChunks(jdata.synthetic_higgs, 12_345, 5_000, seed=11)
    t = tio.SyntheticChunks(tdata.synthetic_higgs, 12_345, 5_000, seed=11)
    assert (t.n_rows, t.n_features, t.n_chunks) == (12_345, 28, 3)
    _same_chunks(_chunks(j), _chunks(PrefetchChunks(t, depth=1)))


def test_prefetch_reraises_producer_errors_and_stops_on_break():
    class Broken(tio.ArrayChunks):
        def _iter_raw_from(self, start_chunk):
            yield from super()._iter_raw_from(start_chunk)
            raise OSError("disk gone")

    X, y = tdata.make_classification(N, 6, 3, seed=0)
    src = PrefetchChunks(Broken(X, y, CHUNK), depth=1)
    with pytest.raises(OSError, match="disk gone"):
        list(src.chunks())
    it = PrefetchChunks(tio.ArrayChunks(X, y, 50), depth=1).chunks()
    next(it)
    it.close()  # the producer thread stops; nothing leaks or hangs


@pytest.mark.parametrize("ratio,replacement", [(1.0, True), (0.7, False)])
def test_chunk_replica_weights_bitwise_equal_to_jax(ratio, replacement):
    jkey, tkey = jax.random.key(5), prng.key(5)
    jrow = jax.random.fold_in(jkey, jstream._CHUNK_STREAM)
    trow = prng.fold_in(tkey, tstream._CHUNK_STREAM)
    ids = torch.arange(6)
    for c, n_valid in enumerate((CHUNK, CHUNK, 100)):
        valid, ck = tstream.chunk_context(trow, c, n_valid, CHUNK)
        got = tboot.bootstrap_weights(ck, ids, CHUNK, ratio=ratio,
                                      replacement=replacement) * valid
        jvalid = (jnp.arange(CHUNK) < n_valid).astype(jnp.float32)
        jck = jax.random.fold_in(jrow, c)
        want = jax.vmap(lambda r: jboot.bootstrap_weights_one(
            jck, r, CHUNK, ratio=ratio, replacement=replacement) * jvalid)(
                jnp.arange(6))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got[:, n_valid:].any()


def _learners(name):
    return {
        "mlp_classifier": (jmlp.MLPClassifier(hidden=8),
                           T.MLPClassifier(hidden=8), "classification"),
        "mlp_regressor": (jmlp.MLPRegressor(hidden=8, activation="tanh"),
                          T.MLPRegressor(hidden=8, activation="tanh"),
                          "regression"),
        "logistic": (J.LogisticRegression(), T.LogisticRegression(),
                     "classification"),
        "linear": (J.LinearRegression(), T.LinearRegression(), "regression"),
    }[name]


def _data(task):
    if task == "classification":
        return tdata.make_classification(N, 6, 3, seed=0)
    return tdata.make_regression(N, 6, seed=0)


def _stream_both(name, max_features=1.0, oob_score=False):
    jl, tl, task = _learners(name)
    X, y = _data(task)
    est = dict(n_estimators=4, max_features=max_features, seed=3,
               oob_score=oob_score)
    if task == "classification":
        jf = J.BaggingClassifier(jl, **est).fit_stream(
            jio.ArrayChunks(X, y, CHUNK), **FIT)
        tf = T.BaggingClassifier(tl, device="cpu", **est).fit_stream(
            tio.ArrayChunks(X, y, CHUNK), **FIT)
    else:
        jf = J.BaggingRegressor(jl, **est).fit_stream(
            jio.ArrayChunks(X, y, CHUNK), **FIT)
        tf = T.BaggingRegressor(tl, device="cpu", **est).fit_stream(
            tio.ArrayChunks(X, y, CHUNK), **FIT)
    return X, y, task, jf, tf


@pytest.mark.parametrize("name,max_features", [
    ("mlp_classifier", 1.0), ("mlp_classifier", 0.8),
    ("mlp_regressor", 0.8), ("logistic", 1.0), ("linear", 0.8),
])
def test_streamed_sgd_fit_matches_jax(name, max_features):
    X, y, task, jf, tf = _stream_both(name, max_features)
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    for k, v in tf.ensemble_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jf.ensemble_[k]),
                                   atol=MLP_TOL, rtol=0, err_msg=k)
    rep = tf.fit_report_
    assert abs(rep["loss_mean"] - jf.fit_report_["loss_mean"]) <= MLP_TOL
    assert (rep["n_chunks"], rep["n_epochs"], rep["opt_steps"]) == (3, 2, 12)
    assert rep["opt_steps"] == jf.fit_report_["opt_steps"]
    if task == "classification":
        np.testing.assert_allclose(tf.predict_proba(X), jf.predict_proba(X),
                                   atol=MLP_TOL, rtol=0)
        np.testing.assert_array_equal(
            tf.predict_stream((X, y), chunk_rows=128), tf.predict(X))
        np.testing.assert_allclose(
            tf.predict_proba_stream(tio.ArrayChunks(X, y, 77)),
            tf.predict_proba(X), atol=1e-7, rtol=0)
        assert tf.score_stream((X, y)) == tf.score(X, y)
    else:
        np.testing.assert_allclose(tf.predict(X), jf.predict(X),
                                   atol=MLP_TOL, rtol=0)
        np.testing.assert_array_equal(
            tf.predict_stream(tio.ArrayChunks(X, y, 128)), tf.predict(X))
        assert tf.score_stream((X, y)) == pytest.approx(tf.score(X, y),
                                                        abs=1e-9)
    assert tf._fitted_learner_fp == jstream.learner_fingerprint(
        jf.base_learner_)


@pytest.mark.parametrize("name", ["mlp_classifier", "linear"])
def test_oob_over_a_stream_matches_jax(name):
    X, y, task, jf, tf = _stream_both(name, 0.8, oob_score=True)
    assert tf.oob_score_ == pytest.approx(jf.oob_score_, abs=MLP_TOL)
    if task == "classification":
        got, want = tf.oob_decision_function_, jf.oob_decision_function_
    else:
        got, want = tf.oob_prediction_, jf.oob_prediction_
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 2])
def test_config4_learner_stream_at_the_card_checks_shapes_matches_jax(seed):
    kw = dict(n_estimators=16, seed=seed)
    fit = dict(classes=[0, 1], n_epochs=2, steps_per_chunk=2, lr=0.01)
    jf = J.BaggingClassifier(jmlp.MLPClassifier(hidden=32, lr=0.01),
                             **kw).fit_stream(
        jio.SyntheticChunks(jdata.synthetic_higgs, 40_000, 5_000, seed=11),
        prefetch=0, **fit)
    tf = T.BaggingClassifier(T.MLPClassifier(hidden=32, lr=0.01),
                             device="cpu", **kw).fit_stream(
        tio.SyntheticChunks(tdata.synthetic_higgs, 40_000, 5_000, seed=11),
        **fit)
    for k, v in tf.ensemble_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jf.ensemble_[k]),
                                   atol=LONG_PARAM_TOL, rtol=0, err_msg=k)
    Xte, _ = tdata.synthetic_higgs(10_000, seed=999_001, structure_seed=11)
    np.testing.assert_allclose(tf.predict_proba(Xte), jf.predict_proba(Xte),
                               atol=MLP_TOL, rtol=0)


def test_padded_rows_carry_no_weight():
    # garbage in the padded tail must not change the fit
    X, y = tdata.make_classification(N, 6, 3, seed=0)

    class Dirty(tio.ArrayChunks):
        def chunks(self):
            for Xc, yc, n in super().chunks():
                Xc = Xc.copy()
                Xc[n:] = 1e6
                yield Xc, yc, n

    fits = [T.BaggingClassifier(T.MLPClassifier(hidden=8), n_estimators=3,
                                device="cpu").fit_stream(src, **FIT)
            for src in (tio.ArrayChunks(X, y, CHUNK), Dirty(X, y, CHUNK))]
    for k in fits[0].ensemble_:
        assert torch.equal(fits[0].ensemble_[k], fits[1].ensemble_[k])


def test_stream_guards_raise_by_name(tmp_path):
    X, y = tdata.make_classification(N, 6, 3, seed=0)
    Xr, yr = tdata.make_regression(N, 6, seed=0)
    tree = T.BaggingClassifier(T.DecisionTreeClassifier(max_depth=2),
                               device="cpu")
    with pytest.raises(ValueError, match="SGD-stream knobs"):
        tree.fit_stream((X, y), n_epochs=2)
    with pytest.raises(ValueError, match="tree streams carry no aux"):
        T.BaggingRegressor(T.DecisionTreeRegressor(max_depth=2),
                           device="cpu").fit_stream((Xr, yr), aux_col=0)
    with pytest.raises(ValueError, match="does not declare uses_aux"):
        T.BaggingRegressor(device="cpu").fit_stream((Xr, yr), aux_col=0)
    # Queue A 11's snapshots run: a snapshot and its resume round trip
    ckpt = str(tmp_path / "ckpt")
    snap = T.BaggingClassifier(n_estimators=2, device="cpu").fit_stream(
        (X, y), checkpoint_dir=ckpt, checkpoint_every=1, prefetch=0)
    again = T.BaggingClassifier(n_estimators=2, device="cpu").fit_stream(
        (X, y), resume_from=ckpt, prefetch=0)
    assert torch.equal(again.ensemble_["W"], snap.ensemble_["W"])
    with pytest.raises(NotImplementedError, match="Queue A 12 part 1b"):
        T.BaggingClassifier(mesh=object(), device="cpu").fit_stream((X, y))
    clf = T.BaggingClassifier(n_estimators=2, device="cpu").fit_stream(
        (X, y), prefetch=0)
    # a stream fit saves and loads (utils/checkpoint.py); its per-chunk
    # weights do not replay, before the round trip or after it
    clf.save(str(tmp_path / "model"))
    back = T.BaggingClassifier.load(str(tmp_path / "model"), device="cpu")
    for est in (clf, back):
        with pytest.raises(ValueError, match="in-memory fit"):
            est.replica_weights(0)
    clf.set_params(warm_start=True)
    with pytest.raises(ValueError, match="warm_start"):
        clf.fit_stream((X, y))
    with pytest.raises(ValueError, match="labels not in classes"):
        T.BaggingClassifier(device="cpu").fit_stream((X, y), classes=[0, 1])
    with pytest.raises(ValueError, match="features"):
        clf.predict_stream((X[:, :3], y))
    # boosting is not tree-streamable: its fit is rounds over the whole
    # dataset, and it has no row loss for the SGD engine either
    gbt = T.GBTClassifier(n_rounds=2, max_depth=2)
    assert not gbt.tree_streamable and not J.GBTClassifier().tree_streamable
    assert T.DecisionTreeRegressor().tree_streamable
    with pytest.raises(TypeError, match="does not support streaming"):
        T.BaggingClassifier(gbt, device="cpu").fit_stream((X, y))
    with pytest.raises(ValueError, match="not tree-streamable"):
        ttree_stream.fit_tree_ensemble_stream(
            gbt, tio.ArrayChunks(X, y, CHUNK), prng.key(0), 2, 3)


def test_a_miscounted_source_is_refused():
    X, y = tdata.make_classification(N, 6, 3, seed=0)

    class Short(tio.ArrayChunks):
        @property
        def n_chunks(self):
            return 4

    with pytest.raises(ValueError, match="n_chunks=4"):
        T.BaggingClassifier(T.LogisticRegression(), n_estimators=2,
                            device="cpu").fit_stream(Short(X, y, CHUNK),
                                                     prefetch=0)


def test_classes_are_discovered_by_a_pass_and_labels_kept():
    X, y = tdata.make_classification(N, 6, 3, seed=0)
    labels = np.array([10, 20, 30])[y]
    clf = T.BaggingClassifier(T.LogisticRegression(), n_estimators=2,
                              device="cpu").fit_stream((X, labels),
                                                       chunk_rows=CHUNK)
    np.testing.assert_array_equal(clf.classes_, [10, 20, 30])
    assert set(np.unique(clf.predict_stream((X, labels)))) <= {10, 20, 30}
