"""The alert engine, the flight recorder and the workload recorder in the
port against the JAX package's (all three are pure Python and numpy in
both packages, so the comparisons are exact):

- ``AlertEngine``: the same rules, the same gauge and counter sequence
  and the same injected clock give the same list of ``alert_fired`` /
  ``alert_resolved`` events (wall-clock ``ts`` aside), the same
  ``state()`` and the same ``sbt_alerts_*`` series; the starter rule
  sets are equal.
- ``FlightRecorder``: a ``refit_rejected`` or ``alert_fired`` event
  writes one dump with the JAX package's keys, and its per-kind
  cooldown keeps it to one dump an incident; arrival events never
  enter the ring.
- The workload recorder: a ``*.workload.jsonl`` written by either
  package loads in the other, ``synthetic_workload`` is equal for the
  same seed, and the recorder captures the port's ``MicroBatcher``
  arrival events (``arrival_events_wanted`` turns on while it
  records).
"""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.telemetry import alerts as jalerts  # noqa: E402
from spark_bagging_tpu.telemetry import recorder as jrecorder  # noqa: E402
from spark_bagging_tpu.telemetry import workload as jworkload  # noqa: E402
from spark_bagging_tpu_torch import telemetry  # noqa: E402
from spark_bagging_tpu_torch.serving import (  # noqa: E402
    EnsembleExecutor,
    MicroBatcher,
)
from spark_bagging_tpu_torch.telemetry import alerts  # noqa: E402
from spark_bagging_tpu_torch.telemetry import recorder  # noqa: E402
from spark_bagging_tpu_torch.telemetry import workload  # noqa: E402

PKGS = ((jtelemetry, jalerts), (telemetry, alerts))


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


def _rules(mod):
    return [
        mod.AlertRule("drift", "sbt_quality_psi_max",
                      labels={"model": "m"}, threshold=0.5,
                      fast_window_s=2.0, slow_window_s=6.0, cooldown_s=4.0),
        mod.AlertRule("low-conf", "sbt_quality_confidence_p50", op="<",
                      threshold=0.6, fast_window_s=1.0, slow_window_s=3.0,
                      cooldown_s=0.0),
        mod.AlertRule("shed-rate", "sbt_serving_overloaded_total",
                      kind="rate", threshold=2.0, fast_window_s=1.0,
                      slow_window_s=2.0, cooldown_s=0.0),
    ]


def _drive(tel, mod, schedule):
    """Run one engine over the schedule of (now, psi, conf, sheds);
    returns the events (ts dropped) the listener saw, the engine's
    state and the alert series."""
    eng = mod.AlertEngine(_rules(mod))
    seen = []
    eng.subscribe(seen.append)
    evaluated = []
    for now, psi_v, conf, sheds in schedule:
        tel.set_gauge("sbt_quality_psi_max", psi_v, labels={"model": "m"})
        if conf is not None:
            tel.set_gauge("sbt_quality_confidence_p50", conf)
        if sheds:
            tel.inc("sbt_serving_overloaded_total", sheds)
        evaluated.extend(eng.evaluate(now=now))
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in evaluated]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in seen]
    series = sorted(
        (e["name"], json.dumps(e.get("labels"), sort_keys=True),
         e.get("value")) for e in tel.registry().snapshot()
        if e["name"].startswith("sbt_alerts"))
    return strip, eng.state(), series


def test_alert_events_state_and_series_equal_jax():
    rng = np.random.default_rng(0)
    schedule = []
    for i in range(60):
        now = i * 0.5
        psi_v = float(rng.uniform(0.0, 0.4)) if i < 20 or i > 45 \
            else float(rng.uniform(0.6, 2.0))
        conf = None if i < 5 else float(0.4 if 30 <= i < 38 else 0.9)
        sheds = int(rng.integers(0, 4)) if 10 <= i < 30 else 0
        schedule.append((now, psi_v, conf, sheds))
    out = [_drive(tel, mod, schedule) for tel, mod in PKGS]
    assert out[0] == out[1]
    kinds = [(e["kind"], e["rule"]) for e in out[1][0]]
    assert ("alert_fired", "drift") in kinds
    assert ("alert_resolved", "drift") in kinds
    assert ("alert_fired", "shed-rate") in kinds


def test_starter_rule_sets_equal_jax():
    for kw in ({}, dict(labels={"model": "m"}, name_prefix="m/",
                        psi_threshold=0.3)):
        assert ([r.to_dict() for r in jalerts.default_drift_rules(**kw)]
                == [r.to_dict() for r in alerts.default_drift_rules(**kw)])
    for kw in ({}, dict(tenancy=False, cooldown_s=10.0)):
        assert ([r.to_dict() for r in jalerts.default_capacity_rules(**kw)]
                == [r.to_dict() for r in alerts.default_capacity_rules(**kw)])
    with pytest.raises(ValueError, match="unknown alert rule fields"):
        alerts.AlertRule.from_dict({"name": "x", "series": "s",
                                    "threshold": 1, "bogus": 2})


def test_install_get_uninstall():
    eng = alerts.install(alerts.default_drift_rules())
    try:
        assert alerts.get() is eng
        assert [r.name for r in eng.rules()] == ["feature-drift",
                                                  "confidence-drift"]
    finally:
        alerts.uninstall()
    assert alerts.get() is None


@pytest.mark.parametrize("kind", ["refit_rejected", "alert_fired"])
def test_flight_dumps_have_the_jax_keys(tmp_path, kind):
    dumps = []
    for tel, rec_mod, sub in ((jtelemetry, jrecorder, "jax"),
                              (telemetry, recorder, "port")):
        rec = rec_mod.FlightRecorder(dir=str(tmp_path / sub),
                                     cooldown_s=3600)
        rec.arm()
        try:
            tel.emit_event({"kind": "serving_request", "rows": 1})
            tel.emit_event({"kind": "model_swapped", "model": "m",
                            "version": 2})
            for _ in range(3):  # one incident, one dump
                tel.emit_event({"kind": kind, "model": "m", "rule": "r",
                                "candidate_score": 0.5})
        finally:
            rec.disarm()
        assert len(rec.dumps) == 1
        assert [e["kind"] for e in rec.events()] == ["model_swapped",
                                                     kind, kind, kind]
        dumps.append((json.load(open(rec.dumps[0])), rec.dump_records[0],
                      rec.timeline_feed()))
    (jd, jr, jt), (td, tr, tt) = dumps
    assert set(jd) == set(td)
    assert set(jd["locks"]) == set(td["locks"])
    assert jd["trigger"]["kind"] == td["trigger"]["kind"] == kind
    assert set(jr) == set(tr) and tr["kind"] == kind
    assert [e["kind"] for e in jt["events"]] == \
        [e["kind"] for e in tt["events"]]
    assert telemetry.registry().counter("sbt_flight_dumps_total").value == 1
    assert telemetry.registry().counter(
        "sbt_flight_dumps_suppressed_total").value == 2


def test_default_recorder_arm_disarm(tmp_path):
    rec = recorder.arm(dir=str(tmp_path))
    try:
        assert recorder.get() is rec and rec.armed
        assert telemetry.sinks_active()
        assert not telemetry.arrival_events_wanted()  # ignores arrivals
    finally:
        recorder.disarm()
    assert not rec.armed


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_synthetic_workloads_equal_and_cross_load(tmp_path, kind):
    kw = dict(rate_rps=300.0, duration_s=0.8, seed=11, rows=(1, 2, 5),
              width=6, bucket_bounds=(1, 64))
    a = jworkload.synthetic_workload(kind, **kw)
    b = workload.synthetic_workload(kind, **kw)
    assert a.header() == b.header()
    assert ([r.to_dict() for r in a.requests]
            == [r.to_dict() for r in b.requests])
    a.save(str(tmp_path / "jax.workload.jsonl"))
    b.save(str(tmp_path / "port.workload.jsonl"))
    assert (open(tmp_path / "jax.workload.jsonl").read()
            == open(tmp_path / "port.workload.jsonl").read())
    in_port = workload.load_workload(str(tmp_path / "jax.workload.jsonl"))
    in_jax = jworkload.load_workload(str(tmp_path / "port.workload.jsonl"))
    assert in_port.summary() == a.summary()
    assert in_jax.summary() == b.summary()


def test_recorder_captures_the_batchers_arrivals(tmp_path):
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(120, 6, 2, seed=0)
    est = T.BaggingClassifier(n_estimators=2, device="cpu").fit(X, y)
    ex = EnsembleExecutor(est, min_bucket_rows=8, max_batch_rows=32)
    ex.warmup([8])
    assert not telemetry.arrival_events_wanted()
    rec = workload.WorkloadRecorder()
    rec.start()
    try:
        assert workload.capture_active() and workload.active() is rec
        assert telemetry.arrival_events_wanted()
        with MicroBatcher(ex, max_delay_ms=1) as b:
            for f in [b.submit(X[i:i + 2]) for i in range(12)]:
                f.result(30)
        window = rec.drain(max_requests=5)
    finally:
        wl = rec.stop()
    assert not telemetry.arrival_events_wanted()
    assert len(window) == 5 and wl.n_requests == 7
    assert all((r.rows, r.width, r.dtype, r.bucket) == (2, 6, "float32", 8)
               for r in window + wl.requests)
    path = wl.save(str(tmp_path / "live.workload.jsonl"))
    assert jworkload.load_workload(path).n_requests == 7
