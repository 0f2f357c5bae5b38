"""The port's spans on the fit and batch-predict paths (CPU).

A pooled-start logistic bag in two replica chunks and a depth-3 tree bag
in two chunks record, under ``telemetry.capture()``:

- ``estimator_fit`` over the whole call, the existing ``h2d``, ``fit``,
  ``aggregate`` and ``quality_profile`` inside it;
- ``fit_prepare`` (the replica-invariant work: the pooled start, the bin
  codes) and one ``replica_chunk`` a chunk (attr ``replicas``), each
  chunk's ``learner_fit``;
- one ``newton_step`` a damped Newton step (the pooled start's too) and
  one ``tree_level`` a level of a chunk (attr ``level``);

and ``predict_proba`` records ``estimator_predict`` over ``predict_h2d``,
``predict_forward`` and ``predict_d2h``. Under a ``torch.profiler``
session each span is also a profiler range of its name, beside the ops
layer's ``scaled_grams``, ``histogram`` and ``bin_codes`` ranges, and a
span's ``ts`` lies on the profiler's clock. A mesh fit's shard spans nest
on their shard's thread. Disarmed, no span is recorded; with no profiler
on, the ops open no range. ``profile_fit`` counts the ranges' device
annotations neither as busy time nor as kernels.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.ops import bootstrap as boot_ops  # noqa: E402
from spark_bagging_tpu_torch.ops import gram as gram_ops  # noqa: E402
from spark_bagging_tpu_torch.ops import hist as hist_ops  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import (  # noqa: E402
    make_classification,
)

R, CHUNK = 6, 4
POOLED_ITER, MAX_ITER, DEPTH = 3, 2, 3
N_CHUNKS = math.ceil(R / CHUNK)
FIT_SPANS = ("estimator_fit", "fit_prepare", "replica_chunk", "learner_fit")
PREDICT_SPANS = ("estimator_predict", "predict_h2d", "predict_forward",
                 "predict_d2h")
NEW_SPANS = FIT_SPANS + ("newton_step", "tree_level") + PREDICT_SPANS
OPS_RANGES = (gram_ops.GRAM_RANGE, hist_ops.HIST_RANGE,
              hist_ops.CODES_RANGE)


def _data():
    return make_classification(400, 8, 3, seed=0)


def _logistic():
    return T.BaggingClassifier(
        T.LogisticRegression(max_iter=MAX_ITER, init="pooled",
                             pooled_iter=POOLED_ITER, hessian_impl="pallas"),
        n_estimators=R, chunk_size=CHUNK, seed=0, device="cpu")


def _trees():
    return T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=DEPTH, n_bins=16,
                                 split_impl="fused"),
        n_estimators=R, chunk_size=CHUNK, max_features=0.8, seed=0,
        device="cpu")


def _paths(spans, name):
    return [e["path"] for e in spans if e["name"] == name]


@pytest.fixture(scope="module")
def recorded():
    X, y = _data()
    out = {}
    for kind, make in (("logistic", _logistic), ("trees", _trees)):
        with telemetry.capture() as run:
            est = make().fit(X, y)
        out[kind] = run.spans()
        with telemetry.capture() as run:
            est.predict_proba(X)
        out[kind + "_predict"] = run.spans()
    return out


def test_logistic_fit_spans_nest_and_count(recorded):
    spans = recorded["logistic"]
    assert _paths(spans, "estimator_fit") == ["estimator_fit"]
    for child in ("h2d", "fit", "aggregate", "quality_profile"):
        assert _paths(spans, child) == [f"estimator_fit/{child}"]
    assert _paths(spans, "fit_prepare") == ["estimator_fit/fit/fit_prepare"]
    chunks = [e for e in spans if e["name"] == "replica_chunk"]
    assert [e["path"] for e in chunks] == (
        ["estimator_fit/fit/replica_chunk"] * N_CHUNKS)
    assert [e["attrs"]["replicas"] for e in chunks] == [CHUNK, R - CHUNK]
    assert _paths(spans, "learner_fit") == (
        ["estimator_fit/fit/replica_chunk/learner_fit"] * N_CHUNKS)
    steps = _paths(spans, "newton_step")
    assert len(steps) == POOLED_ITER + N_CHUNKS * MAX_ITER
    assert steps.count("estimator_fit/fit/fit_prepare/newton_step") == (
        POOLED_ITER)
    assert steps.count(
        "estimator_fit/fit/replica_chunk/learner_fit/newton_step") == (
        N_CHUNKS * MAX_ITER)
    assert not _paths(spans, "tree_level")


def test_tree_fit_spans_nest_and_count(recorded):
    spans = recorded["trees"]
    assert _paths(spans, "fit_prepare") == ["estimator_fit/fit/fit_prepare"]
    assert len(_paths(spans, "replica_chunk")) == N_CHUNKS
    levels = [e for e in spans if e["name"] == "tree_level"]
    assert [e["path"] for e in levels] == (
        ["estimator_fit/fit/replica_chunk/learner_fit/tree_level"]
        * (DEPTH * N_CHUNKS))
    assert [e["attrs"]["level"] for e in levels] == (
        list(range(DEPTH)) * N_CHUNKS)
    assert not _paths(spans, "newton_step")


def test_every_child_span_lies_inside_its_parent(recorded):
    """A child's interval lies in the interval of the latest span of its
    parent's path that started before it."""
    for kind in ("logistic", "trees", "logistic_predict", "trees_predict"):
        spans = recorded[kind]
        for e in spans:
            parent = e["path"].rsplit("/", 1)[0]
            if parent == e["path"]:
                continue
            outer = [p for p in spans if p["path"] == parent
                     and p["ts"] <= e["ts"]]
            assert outer, (kind, e["path"])
            p = max(outer, key=lambda p: p["ts"])
            assert e["ts"] + e["seconds"] <= p["ts"] + p["seconds"] + 1e-3


@pytest.mark.parametrize("kind", ["logistic", "trees"])
def test_predict_proba_records_its_phases(recorded, kind):
    spans = recorded[kind + "_predict"]
    assert [e["path"] for e in spans] == [
        "estimator_predict/predict_h2d",
        "estimator_predict/predict_forward",
        "estimator_predict/predict_d2h",
        "estimator_predict",
    ]


def test_regressor_fit_and_predict_record_the_estimator_spans():
    from spark_bagging_tpu_torch.utils.datasets import make_regression

    X, y = make_regression(200, 5, seed=0)
    reg = T.BaggingRegressor(
        T.DecisionTreeRegressor(max_depth=2, n_bins=8, split_impl="fused"),
        n_estimators=4, seed=0, device="cpu")
    with telemetry.capture() as run:
        reg.fit(X, y)
        reg.predict(X)
    names = [e["path"] for e in run.spans()]
    assert names.count("estimator_fit") == 1
    assert names.count("estimator_fit/fit/fit_prepare") == 1
    assert names.count("estimator_fit/fit/replica_chunk") == 1
    assert names.count(
        "estimator_fit/fit/replica_chunk/learner_fit/tree_level") == 2
    assert names[-4:] == ["estimator_predict/predict_h2d",
                          "estimator_predict/predict_forward",
                          "estimator_predict/predict_d2h",
                          "estimator_predict"]


def _profiled(tmp_path):
    """The two fits and a predict each under one CPU profiler session
    and one capture: the capture's spans and the trace's ranges."""
    from torch.profiler import ProfilerActivity, profile

    X, y = _data()
    with telemetry.capture() as run:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the first range a process opens stamps its start before a
            # one-time set-up (1.4 ms on an idle host, tens under load),
            # which would fall between the range's and the span's stamps
            with torch.profiler.record_function("warm_up"):
                pass
            _logistic().fit(X, y).predict_proba(X)
            _trees().fit(X, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    ranges = [e for e in doc["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return run.spans(), ranges, float(doc["baseTimeNanoseconds"])


def test_spans_are_profiler_ranges_on_the_same_clock(tmp_path):
    spans, ranges, base_ns = _profiled(tmp_path)
    by_name = {}
    for r in ranges:
        by_name.setdefault(r["name"], []).append(r)
    for name in NEW_SPANS:
        got = sorted(e["ts"] for e in spans if e["name"] == name)
        want = sorted(base_ns / 1e9 + r["ts"] / 1e6
                      for r in by_name.get(name, []))
        assert len(got) == len(want) > 0, name
        # the span's epoch stamp and the range's start: one clock
        assert max(abs(a - b) for a, b in zip(got, want)) < 2e-3, name
    # the ops layer's ranges: each Gram of the logistic bag's Newton
    # steps, each tree level's histogram, the trees' one bin-codes call
    assert len(by_name[gram_ops.GRAM_RANGE]) == POOLED_ITER + (
        N_CHUNKS * MAX_ITER)
    assert len(by_name[hist_ops.HIST_RANGE]) == DEPTH * N_CHUNKS
    assert len(by_name[hist_ops.CODES_RANGE]) == 1


def _call_every_ops_entry_point():
    g = torch.Generator().manual_seed(0)
    X = torch.randn(64, 3, generator=g)
    edges = torch.sort(torch.randn(3, 4, generator=g), dim=1).values
    node = torch.zeros(2, 64, dtype=torch.int32)
    S = torch.rand(2, 64, 2, generator=g)
    hist_ops.binned_left_stats(X, edges, node, S, n_nodes=1)
    codes = hist_ops.bin_codes(X, edges)
    hist_ops.coded_left_stats(codes, edges, node, S, n_nodes=1)
    gram_ops.scaled_grams(X, S)
    boot_ops.bootstrap_weights(prng.key(0), torch.arange(2), 64)


def test_ops_ranges_wrap_every_entry_point(tmp_path):
    """``binned_left_stats`` and ``coded_left_stats`` open the histogram
    range, ``bin_codes`` the codes range, ``scaled_grams`` the Gram's and
    ``bootstrap_weights`` the draws'."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call_every_ops_entry_point()
    names = [e.name for e in prof.events()]
    for name, count in ((hist_ops.HIST_RANGE, 2), (hist_ops.CODES_RANGE, 1),
                        (gram_ops.GRAM_RANGE, 1), (boot_ops.DRAW_RANGE, 1)):
        assert names.count(name) == count, name


def test_ops_ranges_are_not_opened_without_a_profiler(monkeypatch):
    """With no profiler session on, the ops open no range: a launch pays
    one flag read, not a ``record_function``."""
    def boom(*a, **k):
        raise AssertionError("a range was opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    _call_every_ops_entry_point()


def test_profile_fit_counts_device_ops_not_range_annotations():
    """A profiler range shows on the device as a user annotation over its
    kernels: ``profile_fit`` counts neither its time as busy nor the
    range as a kernel."""
    from types import SimpleNamespace

    from spark_bagging_tpu_torch.profile_fit import (
        _busy_seconds,
        _is_device_op,
    )

    cuda = torch.autograd.DeviceType.CUDA

    def ev(start, end, annotation=False, device=cuda):
        return SimpleNamespace(
            device_type=device, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=start, end=end))

    kernels = [ev(0.0, 10.0), ev(5.0, 20.0), ev(30.0, 40.0)]
    ranges = [ev(0.0, 100.0, annotation=True),  # an estimator_fit span
              ev(25.0, 45.0, annotation=True)]
    host = [ev(0.0, 200.0, device=torch.autograd.DeviceType.CPU)]
    assert [_is_device_op(e) for e in kernels + ranges + host] == (
        [True] * 3 + [False] * 3)
    # microseconds in, seconds out: [0, 20) and [30, 40)
    assert _busy_seconds(kernels + ranges + host) == pytest.approx(30e-6)


def test_mesh_shard_spans_nest_on_their_own_thread():
    from spark_bagging_tpu_torch.parallel import make_mesh

    X, y = _data()
    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    with telemetry.capture() as run:
        T.BaggingClassifier(T.LogisticRegression(max_iter=1), n_estimators=4,
                            seed=0, device="cpu", mesh=mesh).fit(X, y)
    spans = run.spans()
    # one chunk a shard, each at the root of its shard's thread
    assert _paths(spans, "replica_chunk") == ["replica_chunk"] * 2
    assert _paths(spans, "learner_fit") == ["replica_chunk/learner_fit"] * 2
    assert _paths(spans, "estimator_fit") == ["estimator_fit"]
    assert _paths(spans, "fit") == ["estimator_fit/fit"]


def test_disarmed_spans_record_nothing(monkeypatch):
    """Disarmed, the fits and the predicts never reach the span
    recorder: each new span is one attribute read."""
    import importlib

    spans_mod = importlib.import_module(
        "spark_bagging_tpu_torch.telemetry.spans")
    from spark_bagging_tpu_torch.telemetry.state import STATE

    def boom(*a, **k):
        raise AssertionError("a disarmed span did work")

    monkeypatch.setattr(STATE, "enabled", False)
    monkeypatch.setattr(spans_mod, "_record_span", boom)
    X, y = _data()
    for make in (_logistic, _trees):
        est = make().fit(X, y)
        assert np.isfinite(est.predict_proba(X)).all()
