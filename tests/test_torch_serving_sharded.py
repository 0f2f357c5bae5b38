"""Replica-sharded and degraded-quorum serving of the port
(``EnsembleExecutor(model, mesh=...)``) on the CPU.

The contracts, as in the JAX package's tests/test_serving_sharded.py:

- a mesh executor serves the single-device executor's bits on every
  ladder rung and ragged plan (the shards' per-replica outputs gathered
  in replica order, then the single-device forward's own reduction);
- a lost shard (``degrade_shards``, or the ``shard-loss`` fault plan at
  ``executor.mesh_forward``) leaves the quorum: every later output is
  bitwise the surviving replicas' aggregate recomputed offline
  (``replica_subset_serving``), and no request fails;
- mesh and single-device programs never share a program-cache entry;
- the serving series (``sbt_serving_shard_*``, ``sbt_serving_degraded*``,
  ``sbt_shardmap_traces_total{kind="serving"}``) count as JAX's do after
  the same calls.

Expected values come from the port's own single-device executor and
from ``replica_sharded_serving`` / ``replica_subset_serving``, never
from the JAX serving paths known to fail on some hosts (ROADMAP Queue
C, reference-side failures).
"""

import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import faults as jfaults  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.serving import EnsembleExecutor as JExecutor  # noqa: E402
from spark_bagging_tpu.serving import program_cache as _jpc  # noqa: E402
from spark_bagging_tpu_torch import faults, telemetry  # noqa: E402
from spark_bagging_tpu_torch.parallel.sharded import (  # noqa: E402
    replica_sharded_serving,
    replica_subset_serving,
)
from spark_bagging_tpu_torch.serving import (  # noqa: E402
    EnsembleExecutor,
    ModelRegistry,
)
from spark_bagging_tpu_torch.serving import program_cache as _pc  # noqa: E402
from spark_bagging_tpu_torch.serving.buckets import pack_plan  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
LADDER = (1, 5, 8, 9, 16, 20, 24, 32, 33, 40, 48, 70)


@pytest.fixture(autouse=True)
def _fresh():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    # both packages start from an empty program cache: the JAX one is
    # process-wide, and another module's programs for the same model and
    # mesh shape would be hits here (and count no compile)
    prev = _pc.install(_pc.ProgramCache(capacity=64))
    jprev = _jpc.install(_jpc.ProgramCache(capacity=64))
    yield
    faults.disarm()
    jfaults.disarm()
    _pc.install(prev)
    _jpc.install(jprev)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(256, 12)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.normal(size=256) > 0)
    return X, y.astype(np.int64)


@pytest.fixture(scope="module")
def clf(data):
    X, y = data
    return T.BaggingClassifier(T.LogisticRegression(max_iter=5),
                               n_estimators=16, seed=0,
                               device="cpu").fit(X, y)


def tmesh(replica=8, data=1):
    return T.make_mesh(data, replica, devices=CPU8[:data * replica])


def _counter(name):
    """The unlabeled series ``name`` (a counter or a gauge), 0 if unset."""
    return next((s["value"] for s in telemetry.registry().snapshot()
                 if s["name"] == name and not s["labels"]), 0.0)


def served(fn, params, subs, X, lo, hi):
    """``fn`` over X as an executor with bucket bounds ``(lo, hi)`` runs
    it: the pack plan's slabs, the last one zero-padded to its bucket,
    padding dropped (a padded slab's bits are its bucket's)."""
    out, off = [], 0
    for bucket in pack_plan(X.shape[0], lo, hi):
        fill = min(bucket, X.shape[0] - off)
        slab = np.zeros((bucket, X.shape[1]), np.float32)
        slab[:fill] = X[off:off + fill]
        out.append(fn(params, subs, torch.as_tensor(slab)).numpy()[:fill])
        off += fill
    return np.concatenate(out)


@pytest.mark.parametrize("kind", ["soft", "hard", "regressor"])
def test_mesh_serving_is_bitwise_the_single_device_executor(data, clf,
                                                            kind):
    X, y = data
    if kind == "soft":
        model = clf
    elif kind == "hard":
        model = T.BaggingClassifier(
            T.DecisionTreeClassifier(max_depth=3, n_bins=16),
            n_estimators=8, voting="hard", max_features=0.75, seed=1,
            device="cpu").fit(X, y)
    else:
        model = T.BaggingRegressor(
            T.DecisionTreeRegressor(max_depth=3, n_bins=16), n_estimators=8,
            chunk_size=3, seed=2, device="cpu").fit(
            X, X[:, 0] - X[:, 2])
    single = EnsembleExecutor(model, min_bucket_rows=8, max_batch_rows=32)
    sharded = EnsembleExecutor(model, min_bucket_rows=8, max_batch_rows=32,
                               mesh=tmesh(4))
    assert sharded.mesh_shape == (1, 4)
    fwd, _rep, params, subs, _dev, n = replica_sharded_serving(
        model, tmesh(4))
    for n_rows in LADDER:
        got = sharded.forward(X[:n_rows])
        np.testing.assert_array_equal(got, single.forward(X[:n_rows]))
        np.testing.assert_array_equal(
            got, served(fwd, params, subs, X[:n_rows], 8, 32))
    assert _counter("sbt_serving_shard_devices") == 4.0


def test_mesh_serving_construction_contracts(data, clf):
    X, y = data
    odd = T.BaggingClassifier(T.LogisticRegression(max_iter=2),
                              n_estimators=6, device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="not divisible"):
        EnsembleExecutor(odd, mesh=tmesh(4))
    with pytest.raises(ValueError, match="data-axis size 1"):
        EnsembleExecutor(clf, mesh=tmesh(4, data=2))
    single = EnsembleExecutor(clf)
    with pytest.raises(ValueError, match="mesh-serving only"):
        single.degrade_shards([0])
    ex = EnsembleExecutor(clf, mesh=tmesh(4))
    with pytest.raises(ValueError, match=r"shard must be in \[0, 4\)"):
        ex.degrade_shards([4])
    assert not ex.degraded and ex.failed_shards == ()
    assert ex.surviving_replicas is None
    assert ex.reset_degraded() is False


def test_degraded_quorum_is_bitwise_the_subset_recompute(data, clf):
    X, _ = data
    ex = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=32,
                          mesh=tmesh(4))
    ex.warmup()
    with pytest.warns(RuntimeWarning, match="shard 1 dropped"):
        ex.degrade_shards([1])
    survivors = [i for i in range(16) if i // 4 != 1]
    fn, _rf, p, s = replica_subset_serving(clf, survivors)
    assert ex.degraded and ex.failed_shards == (1,)
    assert ex.surviving_replicas == 12
    for n in (1, 8, 20, 70):
        np.testing.assert_array_equal(ex.forward(X[:n]),
                                      served(fn, p, s, X[:n], 8, 32))
    # a second loss subsets the healthy universe, not the degraded one
    with pytest.warns(RuntimeWarning):
        ex.degrade_shards([3, 3])
    fn2, _rf, p2, s2 = replica_subset_serving(
        clf, [i for i in range(16) if i // 4 in (0, 2)])
    np.testing.assert_array_equal(ex.forward(X[:9]),
                                  served(fn2, p2, s2, X[:9], 8, 32))
    assert _counter("sbt_serving_shard_failures_total") == 2.0
    assert _counter("sbt_serving_degraded_replicas") == 8.0
    with pytest.raises(ValueError, match="at least one"):
        replica_subset_serving(clf, [])
    assert ex.reset_degraded() is True
    single = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=32)
    np.testing.assert_array_equal(ex.forward(X[:20]), single.forward(X[:20]))
    assert _counter("sbt_serving_degraded") == 0.0


def test_shard_loss_plan_fires_and_degrades_with_no_failed_request(
        data, clf):
    """The builtin ``shard-loss`` plan fires at ``executor.mesh_forward``
    on its 4th hit (the 4th slab): that slab and every later one serve
    the survivors' aggregate, bitwise, and no forward raises."""
    X, _ = data
    ex = EnsembleExecutor(clf, min_bucket_rows=1, max_batch_rows=16,
                          mesh=tmesh(4))
    ex.warmup()
    single = EnsembleExecutor(clf, min_bucket_rows=1, max_batch_rows=16)
    single.warmup()
    c0 = _counter("sbt_serving_compiles_total")
    survivors = [i for i in range(16) if i // 4 != 1]
    fn, _rf, p, s = replica_subset_serving(clf, survivors)
    plan = faults.arm(faults.builtin_plan("shard-loss"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for k in range(8):
            rows = X[k * 4:k * 4 + 4]  # one slab (bucket 4) a request
            got = ex.forward(rows)
            want = (single.forward(rows) if k < 3 else
                    served(fn, p, s, rows, 1, 16))
            np.testing.assert_array_equal(got, want)
    faults.disarm()
    assert plan.snapshot()["fired_total"] == 1
    assert ex.failed_shards == (1,) and ex.surviving_replicas == 12
    # degraded programs count apart from serving builds
    assert _counter("sbt_serving_compiles_total") == c0
    assert _counter("sbt_serving_degraded_compiles_total") >= 1


def test_mesh_and_single_device_programs_never_share_a_key(clf):
    single = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=8)
    c0 = _counter("sbt_serving_compiles_total")
    single.warmup()
    sharded = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=8,
                               mesh=tmesh(8))
    sharded.warmup()
    assert _counter("sbt_serving_compiles_total") - c0 == 2
    assert single._program_key(8) != sharded._program_key(8)
    assert sharded._program_key(8).mesh == (1, 8)
    twin = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=8,
                            mesh=tmesh(8))
    assert twin.warmup() == (8,)
    assert _counter("sbt_serving_compiles_total") - c0 == 2
    assert _pc.mesh_shape(tmesh(4)) == (1, 4) and _pc.mesh_shape(None) is None


def test_serving_series_equal_jax(data):
    """The same model (the JAX fit's weights in both packages), the same
    mesh executor calls and the same ``shard-loss`` drill: every mesh and
    degraded serving series reads the same in both packages."""
    X, y = data
    jc = J.BaggingClassifier(J.LogisticRegression(max_iter=5),
                             n_estimators=16, seed=0).fit(X, y)
    tc = T.BaggingClassifier.from_jax_arrays(
        {"W": np.asarray(jc.ensemble_["W"])}, np.asarray(jc.subspaces_),
        classes=jc.classes_, n_features=12,
        base_learner=T.LogisticRegression(max_iter=5), device="cpu")
    names = ["sbt_serving_shard_forwards_total",
             "sbt_serving_shard_failures_total",
             "sbt_serving_degraded_forwards_total",
             "sbt_serving_degraded_compiles_total",
             "sbt_serving_compiles_total", "sbt_serving_shard_devices",
             "sbt_serving_degraded", "sbt_serving_degraded_replicas"]

    def drive(ex, fx):
        ex.warmup()
        fx.arm(fx.builtin_plan("shard-loss"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for k in range(7):
                ex.forward(X[k * 5:k * 5 + 5])
        fx.disarm()

    drive(EnsembleExecutor(tc, min_bucket_rows=8, max_batch_rows=16,
                           mesh=tmesh(4)), faults)
    drive(JExecutor(jc, min_bucket_rows=8, max_batch_rows=16,
                    mesh=J.make_mesh(1, 4, devices=__import__(
                        "jax").devices()[:4])), jfaults)

    def read(tel):
        out = {}
        for s in tel.registry().snapshot():
            if s["name"] in names and not s["labels"]:
                out[s["name"]] = s["value"]
            if (s["name"] == "sbt_shardmap_traces_total"
                    and s["labels"].get("kind") == "serving"):
                out[("traces", s["labels"]["mesh"])] = s["value"]
        return out

    got, want = read(telemetry), read(jtelemetry)
    assert got == want
    assert got["sbt_serving_shard_failures_total"] == 1.0


def test_registry_rebuilds_a_saved_serving_mesh(data, clf, tmp_path,
                                               monkeypatch):
    """``serve_config.json`` records the serving mesh; a load rebuilds it
    over a prefix of the process's devices, or serves single-device with
    a warning where it cannot (a malformed entry degrades the same way)."""
    import json

    from spark_bagging_tpu_torch.serving import registry as reg_mod

    X, _ = data
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    reg.register("m", clf, mesh=tmesh(4))
    path = str(tmp_path / "m")
    reg.save("m", path)
    cfg = json.load(open(f"{path}/serve_config.json"))
    assert cfg["executor"]["mesh"] == [1, 4]
    monkeypatch.setattr(reg_mod, "host_devices", lambda device: CPU8)
    back = ModelRegistry().load("m", path, device="cpu")
    assert back.mesh_shape == (1, 4)
    np.testing.assert_array_equal(back.forward(X[:9]),
                                  EnsembleExecutor(clf).forward(X[:9]))
    monkeypatch.setattr(reg_mod, "host_devices", lambda device: CPU8[:1])
    with pytest.warns(UserWarning, match="cannot build"):
        lone = ModelRegistry().load("m", path, device="cpu")
    assert lone.mesh_shape is None
    cfg["executor"]["mesh"] = [1]
    json.dump(cfg, open(f"{path}/serve_config.json", "w"))
    with pytest.warns(UserWarning, match="cannot build"):
        assert ModelRegistry().load("m", path,
                                    device="cpu").mesh_shape is None
