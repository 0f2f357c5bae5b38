"""Mesh stream fits (``fit_stream(mesh=)``: streaming.py and
tree_stream.py over ``parallel/compat.shard_map``) against the JAX
package's on its 8-device CPU mesh.

The port's mesh is ``[torch.device("cpu")] * 8``, each shard a thread.
Both packages stream the same numpy chunks (500 rows in chunks of 200,
the last padded).

- The SGD engine draws each chunk's weights over the whole chunk, as
  on one device, and each data shard takes its slice: every chunk's
  weights are bitwise the single-device stream's (and so JAX's,
  tests/test_torch_stream.py). The losses and gradients sum over
  ``data`` before each Adam step, so the (2, 4) fit and its OOB
  estimate are JAX's mesh stream within the streams' MLP_TOL (1e-5; 12
  Adam steps, tests/test_torch_stream.py says why).
- The tree engine on a data mesh folds the shard into each chunk's
  draw, as JAX does, and its tables are integers: Gini trees on (2, 2)
  are bitwise JAX's (2, 4) trees, ``leaf_logp`` within 2 ulps (XLA's
  ``log``). Its snapshots record the data-axis size, cross-load with
  JAX's in both directions, and refuse a resume on another data size.
"""

import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.utils import io as jio  # noqa: E402
from spark_bagging_tpu_torch import streaming as tstream  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights  # noqa: E402
from spark_bagging_tpu_torch.parallel import compat  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tdata  # noqa: E402
from spark_bagging_tpu_torch.utils import io as tio  # noqa: E402

MLP_TOL = 1e-5
LOGP_ULPS = 2
CPU8 = [torch.device("cpu")] * 8
N, CHUNK = 500, 200
FIT = dict(n_epochs=2, steps_per_chunk=2, lr=0.05, prefetch=0)
TREE = dict(max_depth=2, n_bins=16)
TREE_EST = dict(n_estimators=8, seed=3, max_features=0.8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the mesh's shard threads are the parallelism
    here, and xdist workers share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tmesh(data, replica=None):
    n = data * (replica or 8 // data)
    return T.make_mesh(data, replica, devices=CPU8[:n])


def jmesh(data):
    return J.make_mesh(data)


def _data():
    return tdata.make_classification(N, 6, 3, seed=0)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# -- the SGD engine -----------------------------------------------------

SGD = {
    "mlp": (lambda m: m.MLPClassifier(hidden=8, lr=0.05)),
    "logistic": (lambda m: m.LogisticRegression()),
}


@pytest.fixture(scope="module")
def sgd_fits():
    """Each learner streamed on a (2, 4) mesh by both packages, with
    OOB; the shared fits of the parity tests below."""
    X, y = _data()
    est = dict(n_estimators=8, max_features=0.8, seed=3, oob_score=True)
    out = {}
    for name, make in SGD.items():
        jf = J.BaggingClassifier(make(J), mesh=jmesh(2), **est).fit_stream(
            jio.ArrayChunks(X, y, CHUNK), **FIT)
        tf = T.BaggingClassifier(make(T), mesh=tmesh(2), device="cpu",
                                 **est).fit_stream(
            tio.ArrayChunks(X, y, CHUNK), **FIT)
        out[name] = (jf, tf)
    return X, y, out


@pytest.mark.parametrize("name", sorted(SGD))
def test_sgd_stream_on_a_2x4_mesh_matches_jax(sgd_fits, name):
    X, _, fits = sgd_fits
    jf, tf = fits[name]
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    for k, v in tf.ensemble_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jf.ensemble_[k]),
                                   atol=MLP_TOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(tf.predict_proba(X), jf.predict_proba(X),
                               atol=MLP_TOL, rtol=0)
    rep = tf.fit_report_
    assert (rep["n_chunks"], rep["opt_steps"], rep["n_devices"]) == (3, 12, 8)
    assert abs(rep["loss_mean"] - jf.fit_report_["loss_mean"]) <= MLP_TOL


@pytest.mark.parametrize("name", sorted(SGD))
def test_oob_over_a_mesh_stream_matches_jax(sgd_fits, name):
    jf, tf = sgd_fits[2][name]
    got, want = tf.oob_decision_function_, jf.oob_decision_function_
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=0)
    assert tf.oob_score_ == pytest.approx(jf.oob_score_, abs=MLP_TOL)


@pytest.mark.parametrize("shape", [(2, 4), (4, 1), (1, 4)])
def test_every_chunks_weights_are_the_single_device_streams(shape,
                                                            monkeypatch):
    """The weights each shard steps on, put back in (replica, row)
    order, are every chunk's single-device weights bit for bit; a data
    shard never folds its index into the draw."""
    X, y = _data()
    seen = []
    original = tstream._loss_and_grad

    def spy(learner, params, Xs, ys, w, *args, **kw):
        seen.append((compat.current_shard(), w.clone()))
        return original(learner, params, Xs, ys, w, *args, **kw)

    monkeypatch.setattr(tstream, "_loss_and_grad", spy)
    est = dict(n_estimators=8, seed=5)
    fit = dict(n_epochs=1, steps_per_chunk=1, prefetch=0)
    T.BaggingClassifier(T.LogisticRegression(), device="cpu",
                        **est).fit_stream(tio.ArrayChunks(X, y, CHUNK), **fit)
    single = [w for _, w in seen]
    seen.clear()
    D, R = shape
    T.BaggingClassifier(T.LogisticRegression(), mesh=tmesh(D, R),
                        device="cpu", **est).fit_stream(
        tio.ArrayChunks(X, y, CHUNK), **fit)
    per_chunk = D * R
    assert len(seen) == per_chunk * len(single)
    for c, want in enumerate(single):
        shards = dict(seen[c * per_chunk:(c + 1) * per_chunk])
        got = torch.cat([torch.cat([shards[(i, j)] for i in range(D)], dim=1)
                         for j in range(R)], dim=0)
        assert torch.equal(got, want), f"chunk {c}"
    # and those are the chunk-keyed draws themselves
    key = prng.key(5)
    row_key = prng.fold_in(key, tstream._CHUNK_STREAM)
    valid, ck = tstream.chunk_context(row_key, 2, N - 2 * CHUNK, CHUNK)
    assert torch.equal(single[2], bootstrap_weights(
        ck, torch.arange(8), CHUNK) * valid)


# -- the tree engine ----------------------------------------------------

@pytest.fixture(scope="module")
def tree_fits(tmp_path_factory):
    """Gini trees streamed with the bootstrap on a data mesh by both
    packages (JAX on (2, 4), the port on (2, 2): data size 2 for both),
    each writing its snapshots."""
    X, y = _data()
    root = tmp_path_factory.mktemp("tree_snapshots")
    jck, tck = str(root / "jax"), str(root / "port")
    jf = J.BaggingClassifier(J.DecisionTreeClassifier(**TREE), mesh=jmesh(2),
                             **TREE_EST).fit_stream(
        jio.ArrayChunks(X, y, CHUNK), prefetch=0, checkpoint_dir=jck)
    tf = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE),
                             mesh=tmesh(2, 2), device="cpu",
                             **TREE_EST).fit_stream(
        tio.ArrayChunks(X, y, CHUNK), prefetch=0, checkpoint_dir=tck)
    return X, y, jf, tf, jck, tck


def test_gini_tree_stream_on_a_data_mesh_is_bitwise_jax(tree_fits):
    X, _, jf, tf, _, _ = tree_fits
    for k in ("feature", "threshold", "gain"):
        np.testing.assert_array_equal(tf.ensemble_[k].numpy(),
                                      np.asarray(jf.ensemble_[k]), err_msg=k)
    assert _ulps(tf.ensemble_["leaf_logp"].numpy(),
                 jf.ensemble_["leaf_logp"]) <= LOGP_ULPS
    np.testing.assert_array_equal(tf.predict(X), jf.predict(X))
    assert tf.fit_report_["n_passes"] == TREE["max_depth"] + 2
    assert tf.fit_report_["n_devices"] == 4


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_deterministic_tree_stream_on_a_mesh_is_the_single_device_one(shape):
    """``bootstrap=False``: every weight is 1, so no shard's draw can
    differ, and the mesh grows the single-device stream's trees bit for
    bit (the edge pass is global, the tables integers)."""
    X, y = _data()
    est = {**TREE_EST, "bootstrap": False}
    one = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE),
                              device="cpu", **est).fit_stream(
        tio.ArrayChunks(X, y, CHUNK), prefetch=0)
    on_mesh = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE),
                                  mesh=tmesh(*shape), device="cpu",
                                  **est).fit_stream(
        tio.ArrayChunks(X, y, CHUNK), prefetch=0)
    for k, v in one.ensemble_.items():
        assert torch.equal(on_mesh.ensemble_[k], v), k


def test_tree_stream_snapshots_cross_load_with_jax(tree_fits, tmp_path):
    """A snapshot written on a data mesh records its data size; each
    package resumes the other's (the last one, written before the leaf
    pass) on a mesh of that data size and ends with the uninterrupted
    fit's trees; a resume on another data size is refused."""
    X, y, jf, tf, jck, tck = tree_fits
    with open(os.path.join(tck, "meta.json")) as f:
        assert json.load(f)["config"]["data_size"] == 2
    t_from_j = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE),
                                   mesh=tmesh(2, 2), device="cpu",
                                   **TREE_EST).fit_stream(
        tio.ArrayChunks(X, y, CHUNK), prefetch=0, resume_from=jck)
    j_from_t = J.BaggingClassifier(J.DecisionTreeClassifier(**TREE),
                                   mesh=jmesh(2), **TREE_EST).fit_stream(
        jio.ArrayChunks(X, y, CHUNK), prefetch=0, resume_from=tck)
    for k in ("feature", "threshold", "gain"):
        want = np.asarray(jf.ensemble_[k])
        np.testing.assert_array_equal(t_from_j.ensemble_[k].numpy(), want)
        np.testing.assert_array_equal(np.asarray(j_from_t.ensemble_[k]),
                                      want)
    assert _ulps(t_from_j.ensemble_["leaf_logp"].numpy(),
                 j_from_t.ensemble_["leaf_logp"]) <= LOGP_ULPS
    # another data size draws other weights: refused, on a mesh and off
    ck = str(tmp_path / "port")
    shutil.copytree(tck, ck)
    for mesh in (tmesh(1, 4), None):
        with pytest.raises(ValueError, match="data_size"):
            T.BaggingClassifier(T.DecisionTreeClassifier(**TREE), mesh=mesh,
                                device="cpu", **TREE_EST).fit_stream(
                tio.ArrayChunks(X, y, CHUNK), prefetch=0, resume_from=ck)


def test_data_sharded_tree_stream_refuses_oob_as_jax():
    X, y = _data()
    est = dict(n_estimators=8, seed=1, oob_score=True)
    errors = []
    for mod, mesh, extra in ((J, jmesh(2), {}),
                             (T, tmesh(2, 2), {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            mod.BaggingClassifier(mod.DecisionTreeClassifier(**TREE),
                                  mesh=mesh, **est, **extra).fit_stream(
                (X, y), chunk_rows=CHUNK, prefetch=0)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "data-sharded tree stream" in errors[1]
    # a replica-only mesh replays the global draws: OOB runs, and is the
    # single-device stream's
    clf = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE),
                              mesh=tmesh(1, 4), device="cpu",
                              **est).fit_stream((X, y), chunk_rows=CHUNK,
                                                prefetch=0)
    one = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE),
                              device="cpu", **est).fit_stream(
        (X, y), chunk_rows=CHUNK, prefetch=0)
    assert clf.oob_score_ == one.oob_score_
