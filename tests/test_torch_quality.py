"""The model-quality plane in the port against the JAX package's.

- The sketches (``P2Quantile``, ``MomentSketch``), ``bin_counts``,
  ``psi``, ``ks_stat`` and ``disagreement_stats`` are numpy in both
  packages: bitwise equal on the same seeded inputs.
- ``ReferenceProfile.from_training`` gives equal ``to_dict()``s; a
  fitted bag's ``quality_profile_`` equals the JAX bag's on the same
  data (logistic, Gini trees, ridge). The OOB confidence histogram is
  binned from ``oob_decision_function_`` (vote fractions: each OOB
  replica's argmax over its OOB count), so it is equal exactly where
  the two packages' OOB decision functions are: the tests assert
  those equal first, then the profiles exactly (no tolerance).
- Checkpoints carry the profile both ways (equal dicts); a malformed
  profile warns and the weights still load.
- ``QualityMonitor`` fed the same ``(parts, outs)`` sequence gives the
  same drift, gauges and ``summary()`` in both packages.
- The executor tap on ``device="cpu"`` (the counterparts of the JAX
  package's tests/test_quality.py executor tests): served outputs
  bitwise with and without the tap; tap builds counted apart from
  serving builds; both dispatch paths feed the monitor; a failing
  monitor detaches with a warning and never fails a request;
  ``enable_quality`` is sticky across ``swap`` and ``load``, its
  ``profile=`` and ``monitor=`` are not; the replica forward's mean
  (soft vote) or vote count (hard vote) is the served output; the
  ``serve_config.json`` of both packages, each with quality enabled,
  agree.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.serving import ModelRegistry as JRegistry  # noqa: E402
from spark_bagging_tpu.telemetry import quality as jq  # noqa: E402
from spark_bagging_tpu.utils import checkpoint as jck  # noqa: E402
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.serving import (  # noqa: E402
    EnsembleExecutor,
    MicroBatcher,
    ModelRegistry,
    program_cache,
)
from spark_bagging_tpu_torch.telemetry import quality as tq  # noqa: E402

R = 8
LADDER = dict(min_bucket_rows=8, max_batch_rows=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_stream.py explains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.normal(size=300) > 0).astype(np.int32)
    return X, y


def _logistic(pkg, **kw):
    return pkg.BaggingClassifier(pkg.LogisticRegression(max_iter=5),
                                 n_estimators=R, seed=0, oob_score=True,
                                 **kw)


def _trees(pkg, **kw):
    return pkg.BaggingClassifier(
        pkg.DecisionTreeClassifier(max_depth=3, n_bins=16,
                                   split_impl="dense"),
        n_estimators=4, max_features=0.7, voting="hard", seed=3,
        oob_score=True, **kw)


def _ridge(pkg, **kw):
    return pkg.BaggingRegressor(pkg.LinearRegression(l2=1e-3),
                                n_estimators=4, seed=5, oob_score=True,
                                **kw)


@pytest.fixture(scope="module")
def clf(data):
    return _logistic(T, device="cpu").fit(*data)


@pytest.fixture(scope="module")
def jclf(data):
    return _logistic(J).fit(*data)


@pytest.fixture(scope="module")
def shared_ex(clf):
    """One warmed executor shared by the tests that only attach and
    detach monitors; tests that count builds make their own."""
    ex = EnsembleExecutor(clf, **LADDER)
    ex.warmup()
    return ex


# -- sketch primitives: numpy on both sides, bitwise ---------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_sketches_psi_and_ks_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=700) * 3.0 + 1.0
    for q in (0.05, 0.5, 0.95):
        a, b = jq.P2Quantile(q), tq.P2Quantile(q)
        for i, v in enumerate(vals):
            a.update(v)
            b.update(v)
            if i in (0, 3, 4, 5, 99, 699):
                assert a.value() == b.value()
    X = rng.normal(size=(400, 5)) * [1.0, 2.0, 0.5, 9.0, 0.1]
    ma, mb = jq.MomentSketch(5), tq.MomentSketch(5)
    for chunk in np.array_split(X, 7):
        ma.update(chunk)
        mb.update(chunk)
    assert ma.count == mb.count
    np.testing.assert_array_equal(ma.mean(), mb.mean())
    np.testing.assert_array_equal(ma.std(), mb.std())
    ref_sample = rng.normal(size=3000)
    edges = np.quantile(ref_sample, np.arange(1, 10) / 10)
    ref_j = jq.bin_counts(ref_sample, edges) / 3000
    ref_t = tq.bin_counts(ref_sample, edges) / 3000
    np.testing.assert_array_equal(ref_j, ref_t)
    for live in (rng.normal(size=40), rng.normal(size=900) + 2.5,
                 np.zeros(0)):
        cj, ct = jq.bin_counts(live, edges), tq.bin_counts(live, edges)
        np.testing.assert_array_equal(cj, ct)
        assert jq.psi(ref_j, cj) == tq.psi(ref_t, ct)
        assert jq.ks_stat(ref_j, cj) == tq.ks_stat(ref_t, ct)
    rep = rng.dirichlet(np.ones(3), size=(R, 50))
    assert (jq.disagreement_stats(rep, "classification")
            == tq.disagreement_stats(rep, "classification"))
    reg = rng.normal(size=(R, 50))
    assert (jq.disagreement_stats(reg, "regression")
            == tq.disagreement_stats(reg, "regression"))


@pytest.mark.parametrize("task", ["classification", "regression", "no_y"])
def test_reference_profile_from_training_equals_jax(task):
    rng = np.random.default_rng(7)
    # more rows than max_rows: the strided quantile pass is exercised
    X = (rng.normal(size=(5000, 4)) * [1, 3, 0.2, 7]).astype(np.float32)
    if task == "classification":
        y, kw = rng.integers(0, 3, 5000), dict(n_classes=3)
    else:
        y, kw = rng.normal(size=5000).astype(np.float32), {}
    if task == "no_y":
        y, task = None, "regression"
    a = jq.ReferenceProfile.from_training(X, y, task=task, **kw)
    b = tq.ReferenceProfile.from_training(X, y, task=task, **kw)
    assert a.to_dict() == b.to_dict()
    oob = rng.uniform(size=800)
    a.set_confidence_reference(oob)
    b.set_confidence_reference(oob)
    assert a.to_dict() == b.to_dict()
    assert tq.ReferenceProfile.from_dict(a.to_dict()).to_dict() == a.to_dict()


@pytest.mark.parametrize("kind", ["logistic", "trees", "ridge"])
def test_fitted_profile_equals_jax(data, kind):
    """Every in-memory fit computes ``quality_profile_``; with
    ``oob_score`` a classifier's carries the OOB confidence reference,
    equal wherever the OOB decision functions are."""
    X, y = data
    if kind == "ridge":
        y = (X @ np.arange(1, 7) + 0.1).astype(np.float32)
    make = {"logistic": _logistic, "trees": _trees, "ridge": _ridge}[kind]
    port = make(T, device="cpu").fit(X, y)
    ref = make(J).fit(X, y)
    if kind != "ridge":
        np.testing.assert_array_equal(port.oob_decision_function_,
                                      np.asarray(ref.oob_decision_function_))
        assert port.quality_profile_.confidence_source == "oob"
    assert port.quality_profile_.to_dict() == ref.quality_profile_.to_dict()
    assert port.quality_profile_.n_rows == len(X)


def test_stream_fit_clears_the_profile_and_warm_growth_recomputes(data):
    X, y = data
    est = T.BaggingClassifier(T.LogisticRegression(max_iter=2),
                              n_estimators=4, seed=0, warm_start=True,
                              device="cpu").fit(X[:200], y[:200])
    first = est.quality_profile_.to_dict()
    est.set_params(n_estimators=6).fit(X[:200], y[:200])
    assert est.quality_profile_.to_dict() == first  # same data, refit
    est.set_params(warm_start=False).fit_stream((X, y), chunk_rows=100,
                                                classes=[0, 1])
    assert est.quality_profile_ is None


def test_profile_failure_warns_and_the_fit_stands(data, monkeypatch):
    X, y = data

    def boom(*a, **k):
        raise RuntimeError("profile exploded")

    monkeypatch.setattr(tq.ReferenceProfile, "from_training", boom)
    with pytest.warns(RuntimeWarning, match="not computed"):
        est = T.BaggingClassifier(n_estimators=2, device="cpu").fit(X, y)
    assert est.quality_profile_ is None and est.n_estimators_ == 2


# -- checkpoints -----------------------------------------------------------

def test_profile_cross_loads_both_ways(tmp_path, clf, jclf):
    clf.save(str(tmp_path / "port"))
    in_jax = jck.load_model(str(tmp_path / "port"))
    assert in_jax.quality_profile_.to_dict() == clf.quality_profile_.to_dict()
    jclf.save(str(tmp_path / "jax"))
    back = T.BaggingClassifier.load(str(tmp_path / "jax"), device="cpu")
    assert back.quality_profile_.to_dict() == jclf.quality_profile_.to_dict()
    assert back.quality_profile_.to_dict() == clf.quality_profile_.to_dict()


def test_malformed_profile_degrades_load_not_bricks_it(tmp_path, clf):
    path = str(tmp_path / "ckpt")
    clf.save(path)
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["fitted"]["quality_profile_"] = {"schema": 1}  # torn
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.warns(UserWarning, match="not restored"):
        loaded = T.BaggingClassifier.load(path, device="cpu")
    assert getattr(loaded, "quality_profile_", None) is None
    assert loaded.n_estimators_ == clf.n_estimators_


# -- the monitor against JAX's ---------------------------------------------

def _quality_gauges(reg) -> dict:
    return {(e["name"], tuple(sorted((e.get("labels") or {}).items()))):
            e.get("value") for e in reg.snapshot()
            if e["name"].startswith("sbt_quality")
            and e["kind"] in ("gauge", "counter")}


def test_monitor_gauges_and_summary_equal_jax(data, clf):
    X, _ = data
    rng = np.random.default_rng(3)
    prof = clf.quality_profile_.to_dict()
    opts = dict(refresh_every=40, disagreement_every=2, min_rows=30,
                export_feature_limit=4, labels={"model": "m"})
    mons = (jq.QualityMonitor(jq.ReferenceProfile.from_dict(prof), **opts),
            tq.QualityMonitor(tq.ReferenceProfile.from_dict(prof), **opts))
    for b in range(12):
        n = int(rng.integers(1, 30))
        parts = [(X[rng.integers(0, len(X), n)]
                  + (3.0 if b >= 6 else 0.0)).astype(np.float32)]
        outs = [rng.dirichlet([1.0, 1.0], size=n).astype(np.float32)]
        rep = rng.dirichlet([1.0, 1.0], size=(R, n))
        for m in mons:
            m.observe_parts(parts, outs)
            if m.wants_disagreement():
                m.observe_disagreement(rep, "classification")
    for m in mons:
        m.refresh()
    dj, dt = mons[0].drift(), mons[1].drift()
    assert dj == dt and dj["warmed"] and dj["psi_max"] > 0.5
    sj, st = mons[0].summary(), mons[1].summary()
    sj.pop("t_attached")
    st.pop("t_attached")
    assert sj == st
    assert (_quality_gauges(jtelemetry.registry())
            == _quality_gauges(telemetry.registry()))


# -- the executor tap (device="cpu") ----------------------------------------

def test_attach_feeds_and_bitwise_parity(clf, shared_ex, data):
    X, _ = data
    ex = shared_ex
    ex.detach_quality()
    base = ex.predict_proba(X[:50])
    mon = tq.attach(ex, refresh_every=1, disagreement_every=1)
    tapped = ex.predict_proba(X[:50])
    np.testing.assert_array_equal(base, tapped)
    assert mon.summary()["rows_observed"] == 50
    assert mon.summary()["disagreement_samples"] == 1
    # the batch API runs other shapes (50 rows, not 32-row slabs): the
    # serving plane's own tolerance, as tests/test_torch_serving.py
    np.testing.assert_allclose(tapped, clf.predict_proba(X[:50]),
                               rtol=0, atol=1e-5)
    assert mon in tq.monitors()
    assert any(m["rows_observed"] == 50
               for m in tq.debug_summary()["monitors"])
    ex.detach_quality()


def test_tap_builds_count_apart_and_attach_prewarms(clf, data):
    X, _ = data
    program_cache.clear()
    ex = EnsembleExecutor(clf, **LADDER)
    ex.warmup()
    reg = telemetry.registry()
    serving0 = reg.counter("sbt_serving_compiles_total").value
    tq.attach(ex, refresh_every=1, disagreement_every=1)
    taps = reg.counter("sbt_quality_disagreement_compiles_total").value
    assert taps == len(ex.compiled_buckets) == len(ex.replica_buckets)
    ex.forward(X[:20])
    ex.forward(X[:3])
    assert reg.counter("sbt_serving_compiles_total").value == serving0
    assert reg.counter("sbt_quality_disagreement_compiles_total").value \
        == taps
    assert reg.counter("sbt_quality_disagreement_samples_total").value == 2
    # a second executor of the same model adopts the tap's programs
    ex2 = EnsembleExecutor(clf, **LADDER)
    ex2.warmup()
    assert ex2.warmup_replica() == ex.replica_buckets
    assert all(ex2.replica_program(b) is ex.replica_program(b)
               for b in ex.replica_buckets)
    assert reg.counter("sbt_quality_disagreement_compiles_total").value \
        == taps
    # release_programs drops the tap's programs with the serving ones
    ex2.release_programs()
    assert ex2.replica_buckets == ()


@pytest.mark.parametrize("kind", ["logistic", "trees", "ridge"])
def test_replica_programs_mean_or_vote_is_the_served_output(data, kind):
    X, y = data
    if kind == "ridge":
        y = (X @ np.arange(1, 7)).astype(np.float32)
    model = {"logistic": _logistic, "trees": _trees,
             "ridge": _ridge}[kind](T, device="cpu").fit(X, y)
    ex = EnsembleExecutor(model, **LADDER)
    ex.warmup([32])
    assert ex.warmup_replica() == (32,)
    Xp = np.zeros((32, X.shape[1]), np.float32)
    Xp[:20] = X[:20]
    rep = ex.replica_program(32).run(Xp, 20)
    served = ex.forward(X[:20])
    fn, params, subs = model.replica_forward()
    eager = fn(params, subs, torch.from_numpy(Xp)).numpy()[:, :20]
    np.testing.assert_array_equal(rep, eager)
    assert rep.shape[:2] == (model.n_estimators_, 20)
    if kind == "trees":
        assert set(np.unique(rep)) <= {0.0, 1.0}
        np.testing.assert_array_equal(rep.sum(0),
                                      np.rint(served * model.n_estimators_))
    else:
        np.testing.assert_allclose(rep.mean(0), served, rtol=1e-6,
                                   atol=1e-6)


def test_both_dispatch_paths_feed_the_monitor(shared_ex, data):
    X, _ = data
    ex = shared_ex
    mon = tq.attach(ex, refresh_every=1)
    with MicroBatcher(ex, max_delay_ms=1.0) as b:
        for _ in range(MicroBatcher.DIRECT_AFTER_SINGLETONS + 4):
            b.predict_proba(X[:1], timeout=30)
        assert telemetry.registry().counter(
            "sbt_serving_direct_dispatch_total").value > 0
    rows_after_direct = mon.summary()["rows_observed"]
    assert rows_after_direct == MicroBatcher.DIRECT_AFTER_SINGLETONS + 4
    with MicroBatcher(ex, max_delay_ms=1.0, direct_dispatch=False) as b:
        b.predict_proba(X[:5], timeout=30)
    assert telemetry.registry().counter(
        "sbt_serving_coalesced_total").value > 0
    assert mon.summary()["rows_observed"] == rows_after_direct + 5
    ex.detach_quality()


def test_monitor_failure_detaches_not_fails_serving(shared_ex, data):
    X, _ = data
    ex = shared_ex
    base = ex.predict_proba(X[:4])

    class Broken:
        def observe_parts(self, parts, outs):
            raise RuntimeError("sketch exploded")

        def wants_disagreement(self):
            return False

    ex.attach_quality(Broken())
    with pytest.warns(RuntimeWarning, match="detached"):
        out = ex.predict_proba(X[:4])
    np.testing.assert_array_equal(out, base)
    assert ex.quality is None
    # a tap whose per-replica program fails while serving: the same
    ex.attach_quality(tq.QualityMonitor(ex.model.quality_profile_,
                                        disagreement_every=1))
    real = ex._replica_piece
    ex._replica_piece = lambda *a: (_ for _ in ()).throw(
        RuntimeError("replay failed"))
    try:
        with pytest.warns(RuntimeWarning, match="detached"):
            out = ex.predict_proba(X[:4])
    finally:
        ex._replica_piece = real
    np.testing.assert_array_equal(out, base)
    assert ex.quality is None


def test_attach_requires_a_profile_and_no_monitor_no_series(clf, shared_ex,
                                                            data):
    X, _ = data
    saved = clf.quality_profile_
    clf.quality_profile_ = None
    try:
        with pytest.raises(ValueError, match="quality_profile_"):
            tq.attach(shared_ex)
    finally:
        clf.quality_profile_ = saved
    shared_ex.detach_quality()
    telemetry.reset()
    shared_ex.forward(X[:20])
    names = {e["name"] for e in telemetry.registry().snapshot()}
    assert not any(n.startswith("sbt_quality") for n in names)


def test_enable_quality_sticky_across_swap_and_load(clf, data, tmp_path):
    X, y = data
    reg = ModelRegistry(**LADDER)
    reg.register("m", clf, warmup=True)
    mon1 = reg.enable_quality("m", refresh_every=1, disagreement_every=1)
    assert mon1.labels == {"model": "m"}
    reg.executor("m").forward(X[:8])
    assert mon1.summary()["rows_observed"] == 8
    new = reg.swap("m", clf)
    mon2 = new.quality
    assert mon2 is not None and mon2 is not mon1
    assert mon2.summary()["rows_observed"] == 0  # fresh sketches
    assert new.replica_buckets == new.compiled_buckets  # re-warmed
    reg.save("m", str(tmp_path / "ck"))
    assert json.load(open(tmp_path / "ck" / "serve_config.json"))["quality"]
    # a load onto the live name is a swap: the monitor re-attaches
    other = _logistic(T, device="cpu").set_params(seed=1).fit(X, y)
    other.save(str(tmp_path / "other"))
    loaded = reg.load("m", str(tmp_path / "other"), device="cpu")
    assert reg.version("m") == 3
    assert loaded.quality is not None and loaded.quality is not mon2
    reg.disable_quality("m")
    assert reg.executor("m").quality is None
    reg.swap("m", clf)
    assert reg.executor("m").quality is None


def test_profile_and_monitor_overrides_are_not_sticky(clf, data):
    X, y = data
    custom = tq.ReferenceProfile.from_training(
        X + 100.0, y, task="classification", n_classes=2)
    reg = ModelRegistry(**LADDER)
    reg.register("m", clf, warmup=True)
    mon1 = reg.enable_quality("m", profile=custom, refresh_every=1)
    assert mon1.profile is custom
    reg.swap("m", clf)
    assert reg.executor("m").quality.profile is clf.quality_profile_
    mine = tq.QualityMonitor(clf.quality_profile_, refresh_every=1)
    assert reg.enable_quality("m", monitor=mine) is mine
    reg.swap("m", clf)
    fresh = reg.executor("m").quality
    assert fresh is not None and fresh is not mine


def test_swap_survives_profileless_replacement(clf, data):
    X, y = data
    reg = ModelRegistry(**LADDER)
    reg.register("m", clf, warmup=True)
    reg.enable_quality("m", refresh_every=1)
    clf2 = T.BaggingClassifier(n_estimators=2, seed=1,
                               device="cpu").fit(X, y)
    clf2.quality_profile_ = None  # a stream fit, an older checkpoint
    with pytest.warns(RuntimeWarning, match="UNMONITORED"):
        reg.swap("m", clf2)
    assert reg.version("m") == 2
    assert reg.executor("m").quality is None


def test_serve_config_quality_flag_matches_jax(clf, jclf, tmp_path):
    """Both packages write ``"quality": true`` for a name with drift
    monitoring enabled (the sticky flag), and the same manifest keys."""
    cfgs = {}
    for name, reg, model in (("port", ModelRegistry(**LADDER), clf),
                             ("jax", JRegistry(**LADDER), jclf)):
        reg.register("m", model, warmup=True)
        reg.enable_quality("m", refresh_every=1)
        reg.save("m", str(tmp_path / name), executables=False)
        cfgs[name] = json.load(open(tmp_path / name / "serve_config.json"))
    port, ref = cfgs["port"], cfgs["jax"]
    assert port["quality"] is ref["quality"] is True
    for cfg in (port, ref):
        cfg.pop("model_fingerprint")  # hashes each package's class path
    assert port == ref
