"""The port's checkpoints against the JAX package's: one format, both ways.

A checkpoint directory is ``manifest.json`` plus the arrays in flax's
msgpack encoding (raw, zlib or zstd). The port writes it with its own
msgpack codec (``spark_bagging_tpu_torch/utils/msgpack.py``) and maps
the JAX package's class paths to its own classes, so:

- a port ``save`` loads with the JAX package's ``load_model`` and a JAX
  ``save`` loads with the port's ``load``, with bitwise-equal parameter
  arrays and equal metadata; predictions from the same weights agree
  within float32 rounding of the two frameworks' products (1e-5;
  hard votes are exact);
- the codec's bytes equal ``msgpack.packb``'s (and flax's
  ``msgpack_serialize``'s) on a seeded tree — ``msgpack`` and ``flax``
  are imported by this test only, never by the port.
"""

import ast
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.utils import checkpoint as jck  # noqa: E402
from spark_bagging_tpu_torch.utils import checkpoint as tck  # noqa: E402
from spark_bagging_tpu_torch.utils import msgpack as tmsgpack  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import (  # noqa: E402
    make_classification,
    make_regression,
)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "spark_bagging_tpu_torch")


@pytest.fixture(scope="module")
def cls_data():
    return make_classification(240, 6, 3, seed=1)


def _port_model(kind, X, y):
    if kind == "classifier":
        return T.BaggingClassifier(T.LogisticRegression(max_iter=4),
                                   n_estimators=5, max_features=0.8, seed=2,
                                   oob_score=True, device="cpu").fit(X, y)
    if kind == "strings":
        return T.BaggingClassifier(n_estimators=3, seed=0, device="cpu").fit(
            X, np.array(["ant", "bee", "cat"])[y])
    if kind == "trees":
        return T.BaggingClassifier(
            T.DecisionTreeClassifier(max_depth=3, n_bins=16), n_estimators=4,
            max_features=0.7, voting="hard", seed=3, device="cpu").fit(X, y)
    Xr, yr = make_regression(240, 5, seed=2)
    return T.BaggingRegressor(T.LinearRegression(l2=1e-3), n_estimators=4,
                              seed=5, oob_score=True, device="cpu").fit(Xr, yr)


def _jax_model(kind, X, y):
    if kind == "classifier":
        return J.BaggingClassifier(J.LogisticRegression(max_iter=4),
                                   n_estimators=5, max_features=0.8, seed=2,
                                   oob_score=True).fit(X, y)
    if kind == "strings":
        return J.BaggingClassifier(n_estimators=3, seed=0).fit(
            X, np.array(["ant", "bee", "cat"])[y])
    if kind == "trees":
        return J.BaggingClassifier(
            J.DecisionTreeClassifier(max_depth=3, n_bins=16), n_estimators=4,
            max_features=0.7, voting="hard", seed=3).fit(X, y)
    Xr, yr = make_regression(240, 5, seed=2)
    return J.BaggingRegressor(J.LinearRegression(l2=1e-3), n_estimators=4,
                              seed=5, oob_score=True).fit(Xr, yr)


def _outputs(est, X):
    if hasattr(est, "predict_proba"):
        return np.asarray(est.predict_proba(X))
    return np.asarray(est.predict(X))


def _same_weights(jax_est, port_est):
    for k, v in port_est.ensemble_.items():
        a = np.asarray(jax_est.ensemble_[k])
        assert a.dtype == v.cpu().numpy().dtype, k
        np.testing.assert_array_equal(a, v.cpu().numpy())
    np.testing.assert_array_equal(np.asarray(jax_est.subspaces_),
                                  port_est.subspaces_.cpu().numpy())


@pytest.mark.parametrize("kind", ["classifier", "regressor", "strings",
                                  "trees"])
def test_port_save_loads_in_jax_and_jax_save_loads_in_port(
        tmp_path, cls_data, kind):
    X, y = cls_data
    Xq = X if kind != "regressor" else make_regression(240, 5, seed=2)[0]
    hard = kind == "trees"
    # port -> JAX
    port = _port_model(kind, X, y)
    port.save(str(tmp_path / "from_port"))
    in_jax = jck.load_model(str(tmp_path / "from_port"))
    assert type(in_jax).__name__ == type(port).__name__
    assert type(in_jax._fitted_learner).__name__ == \
        type(port._fitted_learner).__name__
    _same_weights(in_jax, port)
    assert in_jax.get_params(deep=False)["seed"] == port.seed
    if hasattr(port, "classes_"):
        np.testing.assert_array_equal(in_jax.classes_, port.classes_)
    if hasattr(port, "oob_score_"):
        assert in_jax.oob_score_ == port.oob_score_
    want, got = _outputs(port, Xq), _outputs(in_jax, Xq)
    if hard:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # JAX -> port
    ref = _jax_model(kind, X, y)
    ref.save(str(tmp_path / "from_jax"))
    back = type(port).load(str(tmp_path / "from_jax"), device="cpu")
    _same_weights(ref, back)
    assert back.fit_report_ == json.loads(json.dumps(ref.fit_report_))
    got, want = _outputs(back, Xq), _outputs(ref, Xq)
    if hard:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if kind == "classifier":
        # the fit key and sampling ride the manifest: the port replays
        # the JAX fit's bootstrap weights bit for bit
        np.testing.assert_array_equal(back.replica_weights(2),
                                      np.asarray(ref.replica_weights(2)))


@pytest.mark.parametrize("codec", ["raw", "zlib", "zstd"])
def test_payload_codecs_round_trip_both_ways(tmp_path, cls_data, codec,
                                             monkeypatch):
    X, y = cls_data
    port = _port_model("classifier", X, y)
    if codec == "zstd":
        pytest.importorskip("zstandard")
    elif codec == "zlib":
        # no zstandard: "auto" falls back to zlib with a warning
        monkeypatch.setattr(tck, "_zstd", lambda: None)
    name = {"raw": "arrays.msgpack", "zlib": "arrays.msgpack.z",
            "zstd": "arrays.msgpack.zst"}[codec]
    path = str(tmp_path / "m")
    if codec == "zlib":
        with pytest.warns(UserWarning, match="zlib"):
            port.save(path)
    else:
        port.save(path, compress=codec != "raw")
    assert sorted(os.listdir(path)) == sorted(["manifest.json", name])
    back = T.BaggingClassifier.load(path, device="cpu")
    np.testing.assert_array_equal(back.predict_proba(X), port.predict_proba(X))
    _same_weights(jck.load_model(path), port)


def test_zstd_payload_without_zstandard_names_the_module(tmp_path, cls_data,
                                                         monkeypatch):
    pytest.importorskip("zstandard")
    X, y = cls_data
    path = str(tmp_path / "m")
    _port_model("classifier", X, y).save(path, compress=True)
    monkeypatch.setattr(tck, "_zstd", lambda: None)
    with pytest.raises(ImportError, match="zstandard"):
        T.BaggingClassifier.load(path, device="cpu")


def _seeded_tree(rng, depth=0):
    """A nested tree of every type the checkpoint's msgpack holds."""
    out = {}
    for i in range(int(rng.integers(3, 7))):
        kind = int(rng.integers(0, 9 if depth < 2 else 8))
        key = "k" * int(rng.integers(1, 40)) + str(i)
        if kind == 0:
            v = int(rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                                2**32 - 1, 2**32, 2**63, -1, -32, -33,
                                -128, -129, -2**15, -2**15 - 1, -2**31,
                                -2**31 - 1, -2**63]))
        elif kind == 1:
            v = float(rng.standard_normal())
        elif kind == 2:
            v = bool(rng.integers(0, 2))
        elif kind == 3:
            v = None
        elif kind == 4:
            v = "é" * int(rng.integers(0, 300))
        elif kind == 5:
            v = bytes(rng.integers(0, 256, int(rng.integers(0, 70000)),
                                   dtype=np.uint8))
        elif kind == 6:
            v = [int(x) for x in rng.integers(-1000, 1000,
                                              int(rng.integers(0, 20)))]
        elif kind == 7:
            shape = tuple(int(s) for s in rng.integers(0, 5, int(
                rng.integers(0, 4))))
            dt = rng.choice(["float32", "int32", "float64", "int64", "uint8",
                             "bool"])
            v = rng.standard_normal(shape).astype(dt)
        else:
            v = _seeded_tree(rng, depth + 1)
        out[key] = v
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_msgpack_codec_bitwise_equal_to_msgpack_and_flax(seed):
    msgpack = pytest.importorskip("msgpack")
    from flax import serialization

    tree = _seeded_tree(np.random.default_rng(seed))
    ext = serialization._msgpack_ext_pack
    # the packer on its own: msgpack with flax's ndarray ext hook
    want = msgpack.packb(tree, default=ext, strict_types=True)
    assert tmsgpack.packb(tree) == want
    # the checkpoint serializer: flax's msgpack_serialize (sorted keys)
    want = serialization.msgpack_serialize(tree)
    assert tmsgpack.serialize(tree) == want
    # and both decoders read the other's bytes back to the same tree
    ours = tmsgpack.restore(want)
    theirs = serialization.msgpack_restore(tmsgpack.serialize(tree))

    def equal(a, b):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                equal(a[k], b[k])
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b and type(a) is type(b)

    equal(ours, theirs)
    assert msgpack.unpackb(want, raw=False, ext_hook=lambda c, d: (c, d)) \
        == tmsgpack.unpackb(want, ext_hook=lambda c, d: (c, d))


def test_wrong_class_unfitted_future_format_and_stale_rng_schema(
        tmp_path, cls_data):
    X, y = cls_data
    path = str(tmp_path / "m")
    with pytest.raises(RuntimeError, match="not fitted"):
        T.BaggingClassifier(device="cpu").save(path)
    clf = _port_model("classifier", X, y)
    clf.save(path)
    with pytest.raises(TypeError, match="not BaggingRegressor"):
        T.BaggingRegressor.load(path, device="cpu")
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    # a stale bootstrap schema: predictions load, weight replay is off
    for stale in (1, None):
        if stale is None:
            manifest["fitted"].pop("rng_schema")
        else:
            manifest["fitted"]["rng_schema"] = stale
        json.dump(manifest, open(mpath, "w"))
        with pytest.warns(UserWarning, match="RNG schema"):
            old = T.BaggingClassifier.load(path, device="cpu")
        np.testing.assert_array_equal(old.predict(X), clf.predict(X))
        with pytest.raises(ValueError, match="in-memory fit"):
            old.replica_weights(0)
    manifest["format_version"] = 99
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ValueError, match="newer"):
        T.BaggingClassifier.load(path, device="cpu")
    # a class of the JAX package the port has no counterpart of
    manifest["format_version"] = 1
    manifest["estimator"] = "spark_bagging_tpu.online.trainer:Trainer"
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(ValueError, match="no counterpart"):
        T.BaggingClassifier.load(path, device="cpu")


def test_torn_write_and_crash_mid_swap_keep_a_loadable_checkpoint(
        tmp_path, cls_data):
    import shutil

    from spark_bagging_tpu_torch import faults

    X, y = cls_data
    path = str(tmp_path / "m")
    a = _port_model("classifier", X, y)
    a.save(path)
    b = T.BaggingClassifier(n_estimators=3, seed=9, device="cpu").fit(X, y)
    plan = faults.FaultPlan([{"site": "checkpoint.write", "action": "kill",
                              "at": [1]}])
    with faults.armed(plan), pytest.raises(faults.SimulatedKill):
        b.save(path)
    # the kill left tmp debris only: the installed checkpoint is a's
    loaded = T.BaggingClassifier.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict_proba(X), a.predict_proba(X))
    # a crash between the swap's two renames leaves the .old slot
    shutil.move(path, path + ".old")
    with pytest.warns(UserWarning, match="mid-swap"):
        loaded = T.BaggingClassifier.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict_proba(X), a.predict_proba(X))
    b.save(path)
    assert not os.path.exists(path + ".old")
    np.testing.assert_array_equal(
        T.BaggingClassifier.load(path, device="cpu").predict_proba(X),
        b.predict_proba(X))


def _module_level_imports(tree):
    """Imports outside every function body (run at module import)."""
    out = []

    def visit(node, in_def):
        for child in ast.iter_child_nodes(node):
            d = in_def or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.Lambda))
            if isinstance(child, (ast.Import, ast.ImportFrom)) and not d:
                out.append(child)
            visit(child, d)

    visit(tree, False)
    return out


def _roots(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if node.module and not node.level:
        return [node.module.split(".")[0]]
    return []


def test_the_port_imports_no_jax_flax_msgpack_and_zstandard_lazily():
    banned = {"jax", "jaxlib", "flax", "msgpack", "optax", "spark_bagging_tpu"}
    found = []
    for root, _, names in os.walk(PKG):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    found += [(path, r) for r in _roots(node) if r in banned]
            for node in _module_level_imports(tree):
                found += [(path, r) for r in _roots(node)
                          if r == "zstandard"]
    assert not found, found
    # the checkpoint module does import zstandard, inside a function
    assert "import zstandard" in open(tck.__file__).read()
