"""The fit and stream telemetry of the port against the JAX package's.

The same fits run through both packages, telemetry armed: a 256 x 8
logistic fit with ``oob_score=True``, then an SGD and a tree
``fit_stream`` over ``ArrayChunks(chunk_rows=64)`` behind
``PrefetchChunks``. Then:

- the eight series (``sbt_h2d_bytes_total``,
  ``sbt_oob_evaluations_total``, ``sbt_stream_epochs_total``,
  ``sbt_stream_chunks_total``, ``sbt_chunk_seconds``,
  ``sbt_chunks_yielded_total``, ``sbt_prefetch_queue_depth``,
  ``sbt_prefetch_stall_seconds_total``), their label keys and their
  ``SERIES_HELP`` text equal JAX's, and so do the two series of the
  multi-process gather (``sbt_collective_seconds``,
  ``sbt_d2h_bytes_total``, emitted in tests/test_torch_multihost.py);
- the spans ``h2d``, ``fit``, ``aggregate``, ``oob``, ``tree_pass`` and
  ``chunk_step`` are recorded as often as JAX records them (``tree_pass``
  with the same kinds and levels);
- the counts (chunks, epochs, OOB evaluations, host-to-device bytes)
  equal JAX's; the prefetch gauge and stall are recorded;
- unarmed, none of the probes reaches the registry or a span: each is
  one attribute read.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.telemetry.registry import (  # noqa: E402
    SERIES_HELP as JSERIES_HELP,
)
from spark_bagging_tpu.utils.prefetch import (  # noqa: E402
    PrefetchChunks as JPrefetchChunks,
)
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.telemetry.registry import (  # noqa: E402
    SERIES_HELP,
)
from spark_bagging_tpu_torch.utils.prefetch import PrefetchChunks  # noqa: E402

SERIES = ("sbt_h2d_bytes_total", "sbt_oob_evaluations_total",
          "sbt_stream_epochs_total", "sbt_stream_chunks_total",
          "sbt_chunk_seconds", "sbt_chunks_yielded_total",
          "sbt_prefetch_queue_depth", "sbt_prefetch_stall_seconds_total")
MULTIHOST_SERIES = ("sbt_collective_seconds", "sbt_d2h_bytes_total")
SPANS = ("h2d", "fit", "aggregate", "oob", "tree_pass", "chunk_step")
#: series whose values are counts, equal in both packages
COUNTED = ("sbt_h2d_bytes_total", "sbt_oob_evaluations_total",
           "sbt_stream_epochs_total", "sbt_stream_chunks_total",
           "sbt_chunks_yielded_total")


def _data():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((256, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int64)
    return X, y


def _fits(mod, prefetch_cls, **kw):
    X, y = _data()
    mod.BaggingClassifier(n_estimators=8, seed=0, oob_score=True,
                          **kw).fit(X, y)
    mod.BaggingClassifier(n_estimators=4, seed=0, **kw).fit_stream(
        prefetch_cls(mod.ArrayChunks(X, y, chunk_rows=64), 2),
        classes=[0, 1], n_epochs=2)
    mod.BaggingClassifier(
        mod.DecisionTreeClassifier(max_depth=2, n_bins=8), n_estimators=4,
        seed=0, **kw).fit_stream(
            prefetch_cls(mod.ArrayChunks(X, y, chunk_rows=64), 2),
            classes=[0, 1])


def _record(mod, tel, prefetch_cls, **kw):
    """``(spans, {(name, labels): entry})`` of the fits."""
    tel.reset()
    try:
        with tel.capture() as run:
            _fits(mod, prefetch_cls, **kw)
            series = {
                (s["name"], tuple(sorted(
                    (k, str(v)) for k, v in s["labels"].items()))): s
                for s in tel.registry().snapshot() if s["name"] in SERIES}
        spans = [(e["name"], e.get("attrs", {}).get("kind"),
                  e.get("attrs", {}).get("level"))
                 for e in run.spans() if e["name"] in SPANS]
    finally:
        tel.reset()
    return spans, series


@pytest.fixture(scope="module")
def recorded():
    return (_record(T, telemetry, PrefetchChunks, device="cpu"),
            _record(J, jtelemetry, JPrefetchChunks))


def test_series_labels_and_help_equal_jax(recorded):
    (_, got), (_, want) = recorded
    assert {n for n, _ in got} == {n for n, _ in want} == set(SERIES)
    assert set(got) == set(want)
    for name in SERIES + MULTIHOST_SERIES:
        assert SERIES_HELP[name] == JSERIES_HELP[name], name


def test_span_names_and_counts_equal_jax(recorded):
    (got, _), (want, _) = recorded
    assert sorted(got) == sorted(want)
    assert {n for n, _, _ in got} == set(SPANS)


def test_counts_equal_jax(recorded):
    (_, got), (_, want) = recorded
    for key, entry in want.items():
        if key[0] in COUNTED:
            assert got[key]["value"] == entry["value"], key
    for key, entry in want.items():
        if key[0] == "sbt_chunk_seconds":
            assert got[key]["count"] == entry["count"], key
    # 256 rows x 8 float32 features copied once
    assert got[("sbt_h2d_bytes_total", (("process", "0"),))]["value"] == (
        256 * 8 * 4)
    assert got[("sbt_prefetch_stall_seconds_total", ())]["value"] > 0


def test_unarmed_probes_are_one_attribute_read(monkeypatch):
    """Disarmed, the fits and streams never reach the registry or a
    span recorder."""
    import importlib

    spans = importlib.import_module("spark_bagging_tpu_torch.telemetry.spans")

    def boom(*a, **k):
        raise AssertionError("an unarmed probe did work")

    from spark_bagging_tpu_torch.telemetry.state import STATE

    monkeypatch.setattr(STATE, "enabled", False)
    for name in ("inc", "set", "observe"):
        monkeypatch.setattr(telemetry.Registry, name, boom)
    monkeypatch.setattr(spans, "_record_span", boom)
    _fits(T, PrefetchChunks, device="cpu")
