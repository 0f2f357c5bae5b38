"""Stream snapshots and resume (streaming.py, tree_stream.py) in the
port, and their format against the JAX package's.

A stream is killed by a chunk source that raises after a set number of
chunks, then resumed from the last snapshot: the resumed fit equals the
uninterrupted one bit for bit (chunk-keyed weight draws do not depend
on when a chunk is visited, and the snapshot holds the parameters and
Adam's state exactly). Snapshots are the JAX package's files
(``state.msgpack`` in flax's layout, ``meta.json``), so a snapshot the
JAX package wrote resumes in the port: the port's resumed fit is then
held to the JAX package's resumed fit within the stream tolerances of
tests/test_torch_stream.py (MLP_TOL 1e-5 on predictions,
LONG_PARAM_TOL 2e-4 on parameters after tens of Adam steps).
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.utils import io as jio  # noqa: E402
from spark_bagging_tpu_torch import streaming as tstream  # noqa: E402
from spark_bagging_tpu_torch.utils import io as tio  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import make_classification  # noqa: E402

MLP_TOL = 1e-5
LONG_PARAM_TOL = 2e-4

# 300 rows in chunks of 64: four full chunks and a padded tail of 44
N, CHUNK = 300, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_stream.py explains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Killed(Exception):
    """The fault a dying chunk source raises."""


def _dying(base, after: int):
    """A chunk source of ``base``'s class (either package's
    ``ArrayChunks``) that raises :class:`Killed` once it has yielded
    ``after`` chunks in all, over every pass the fit makes."""

    class Dying(base):
        def chunks_from(self, start):
            for chunk in super().chunks_from(start):
                if self.yielded >= after:
                    raise Killed(f"killed after {after} chunks")
                self.yielded += 1
                yield chunk

    def make(X, y):
        src = Dying(X, y, CHUNK)
        src.yielded = 0
        return src

    return make


def _data():
    return make_classification(N, 5, 3, seed=4)


LEARNERS = {
    "logistic": (lambda pkg: pkg.LogisticRegression(),
                 dict(n_epochs=2, steps_per_chunk=2, lr=0.05)),
    "mlp": (lambda pkg: pkg.MLPClassifier(hidden=4),
            dict(n_epochs=2, steps_per_chunk=2, lr=0.05)),
    "tree": (lambda pkg: pkg.DecisionTreeClassifier(max_depth=3, n_bins=8),
             {}),
}


def _port(kind, **kw):
    learner, fit = LEARNERS[kind]
    est = T.BaggingClassifier(learner(T), n_estimators=4, max_features=0.8,
                              device="cpu")
    return est, dict(classes=[0, 1, 2], prefetch=0, **fit, **kw)


def _equal(a, b):
    assert set(a.ensemble_) == set(b.ensemble_)
    for k in a.ensemble_:
        assert torch.equal(a.ensemble_[k], b.ensemble_[k]), k
    assert torch.equal(a.subspaces_, b.subspaces_)


@pytest.mark.parametrize("kind,kill_after", [
    ("logistic", 7),  # in epoch 1, after the snapshot at step 6
    ("mlp", 4),       # in epoch 0, after the snapshot at step 4
    ("tree", 17),     # in level pass 2 (5 chunks a pass)
])
def test_resumed_stream_equals_the_uninterrupted_fit(tmp_path, kind,
                                                     kill_after):
    X, y = _data()
    est, kw = _port(kind)
    full = est.fit_stream(tio.ArrayChunks(X, y, CHUNK), **kw)
    ckpt = str(tmp_path / "ckpt")
    est, kw = _port(kind, checkpoint_dir=ckpt, checkpoint_every=2)
    with pytest.raises(Killed):
        est.fit_stream(_dying(tio.ArrayChunks, kill_after)(X, y), **kw)
    meta = json.load(open(os.path.join(ckpt, "meta.json")))
    if kind == "tree":
        # snapshots after the edge pass and each finished level
        assert meta["next_pass"] == kill_after // 5
    else:
        assert meta["steps_done"] == kill_after - kill_after % 2
    est, kw = _port(kind, resume_from=ckpt)
    resumed = est.fit_stream(tio.ArrayChunks(X, y, CHUNK), **kw)
    _equal(resumed, full)
    np.testing.assert_array_equal(resumed.predict_proba(X),
                                  full.predict_proba(X))
    if kind == "tree":
        # a resumed tree stream reports no FLOPs figure (it skipped
        # passes: JAX's report then has no FLOP keys); the
        # uninterrupted one does
        assert "achieved_tflops" not in resumed.fit_report_
        assert full.fit_report_["model_flops_per_fit"]
    else:
        # the resumed call counts only its own steps
        steps = meta["steps_done"] * 2
        assert (full.fit_report_["opt_steps"]
                - resumed.fit_report_["opt_steps"]) == steps


def test_resume_refusals(tmp_path):
    X, y = _data()
    ckpt = str(tmp_path / "ckpt")
    est, kw = _port("logistic", checkpoint_dir=ckpt, checkpoint_every=3)
    est.fit_stream((X, y), chunk_rows=CHUNK, **kw)
    # another fit configuration: the keys that differ are named
    est, kw = _port("logistic", resume_from=ckpt)
    with pytest.raises(ValueError, match=r"different fit configuration "
                       r"\(mismatched: \['lr'\]\)"):
        est.fit_stream((X, y), chunk_rows=CHUNK, **{**kw, "lr": 0.1})
    # a source of another length
    with pytest.raises(ValueError, match=r"mismatched: \['n_chunks', "
                       r"'n_rows'\]"):
        est.fit_stream((X[:-70], y[:-70]), chunk_rows=CHUNK, **kw)
    # a snapshot that could never be written
    est, kw = _port("logistic", checkpoint_dir=ckpt, checkpoint_every=0)
    with pytest.raises(ValueError, match="checkpoint_every is 0"):
        est.fit_stream((X, y), chunk_rows=CHUNK, **kw)
    # trees ignore checkpoint_every but refuse a foreign snapshot
    est, kw = _port("tree", resume_from=ckpt)
    with pytest.raises(ValueError, match="different fit configuration"):
        est.fit_stream((X, y), chunk_rows=CHUNK, **kw)
    # a fitted warm_start estimator still cannot extend through a stream
    est = T.BaggingClassifier(n_estimators=2, warm_start=True,
                              device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="cannot extend an ensemble via "
                       "fit_stream"):
        est.fit_stream((X, y), resume_from=ckpt)


def test_snapshot_install_is_atomic(tmp_path):
    path = str(tmp_path / "snap")
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "l": []}
    tstream.save_snapshot(path, tree, {"n": 1})
    tstream.save_snapshot(path, {**tree, "a": tree["a"] + 1}, {"n": 2})
    assert sorted(os.listdir(tmp_path)) == ["snap"]
    # a kill between the two renames leaves only path.old: it loads
    os.replace(path, path + ".old")
    meta, state = tstream._load_stream_checkpoint(path)
    assert meta == {"n": 2}
    np.testing.assert_array_equal(state["a"], tree["a"] + 1)
    # the next snapshot installs and drops the stale .old
    tstream.save_snapshot(path, tree, {"n": 3})
    assert sorted(os.listdir(tmp_path)) == ["snap"]
    # a dead writer's tmp dir is reaped; a live process's is kept
    dead = subprocess.run([sys.executable, "-c",
                           "import os; print(os.getpid())"],
                          capture_output=True, text=True, check=True)
    dead_tmp = f"{path}.tmp.{int(dead.stdout)}"
    live_tmp = f"{path}.tmp.{os.getppid()}"
    for d in (dead_tmp, live_tmp):
        os.makedirs(d)
    tstream.save_snapshot(path, tree, {"n": 4})
    assert not os.path.exists(dead_tmp)
    assert os.path.isdir(live_tmp)
    assert tstream._load_stream_checkpoint(path)[0] == {"n": 4}


@pytest.mark.parametrize("kind", ["mlp", "tree"])
def test_jax_snapshot_resumes_in_the_port(tmp_path, kind):
    """A snapshot the JAX package wrote mid-stream resumes in the port,
    and the port's snapshot resumes in the JAX package: each resumed
    fit against the JAX package's own resumed fit (Gini trees bitwise,
    leaf log-probabilities within 2 ulps; the MLP within the stream
    tolerances)."""
    X, y = _data()
    learner, fit = LEARNERS[kind]
    kill_after = 6 if kind == "mlp" else 12
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "port")

    def jax_est():
        return J.BaggingClassifier(learner(J), n_estimators=4,
                                   max_features=0.8)

    jkw = dict(classes=[0, 1, 2], prefetch=0, **fit)
    with pytest.raises(Killed):
        jax_est().fit_stream(_dying(jio.ArrayChunks, kill_after)(X, y),
                             checkpoint_dir=jck, checkpoint_every=2, **jkw)
    want = jax_est().fit_stream(jio.ArrayChunks(X, y, CHUNK),
                                resume_from=jck, **jkw)
    est, kw = _port(kind, resume_from=jck)
    got = est.fit_stream(tio.ArrayChunks(X, y, CHUNK), **kw)
    # and the other way: the port's snapshot resumed by the JAX package
    est, kw = _port(kind, checkpoint_dir=tck, checkpoint_every=2)
    with pytest.raises(Killed):
        est.fit_stream(_dying(tio.ArrayChunks, kill_after)(X, y), **kw)
    back = jax_est().fit_stream(jio.ArrayChunks(X, y, CHUNK),
                                resume_from=tck, **jkw)
    np.testing.assert_array_equal(np.asarray(want.subspaces_),
                                  got.subspaces_.numpy())
    for jfit in (want, back):
        if kind == "tree":
            for k in ("feature", "threshold", "gain"):
                np.testing.assert_array_equal(
                    np.asarray(jfit.ensemble_[k]), got.ensemble_[k].numpy(),
                    err_msg=k)
            np.testing.assert_array_max_ulp(
                np.asarray(jfit.ensemble_["leaf_logp"]),
                got.ensemble_["leaf_logp"].numpy(), maxulp=2)
        else:
            for k, leaf in jfit.ensemble_.items():
                np.testing.assert_allclose(got.ensemble_[k].numpy(),
                                           np.asarray(leaf), rtol=0,
                                           atol=LONG_PARAM_TOL, err_msg=k)
            np.testing.assert_allclose(got.predict_proba(X),
                                       jfit.predict_proba(X), rtol=0,
                                       atol=MLP_TOL)
