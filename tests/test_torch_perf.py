"""The performance-attribution plane in the port, held against the JAX
package's:

- ``correlate_tail``: the same slow-request records and process events
  (seeded: error flags, queue shares, every event kind the verdict
  ladder reads, span events, tenancy sheds) give the same verdicts,
  factors and evidence;
- ``PerfAttribution.summary()`` and ``cost_model()``: the same
  breakdowns and forward observations with the same per-bucket costs
  give the same stage totals and shares, the same per-(path, model)
  keys, the same cost table and the same slow reservoir (wall-clock
  ``ts`` pinned in both), on the CPU where neither knows a peak;

and the JAX package's contracts, copied: the stages partition the
wall-clock, the key cap bounds the registry too, the executor probe
feeds an installed plane only (joined with the executor's counted
``bucket_costs``), the batcher probe rides the breakdown with shares
summing to 1 per path, the unarmed probe is one attribute read, and
``tail_report`` joins the reservoir with the flight recorder's ring.
The exact comparisons hold because both planes are the same host
arithmetic.
"""

import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.telemetry import perf as jperf  # noqa: E402
from spark_bagging_tpu_torch import (  # noqa: E402
    BaggingClassifier,
    LogisticRegression,
    telemetry,
)
from spark_bagging_tpu_torch.serving import (  # noqa: E402
    EnsembleExecutor,
    MicroBatcher,
)
from spark_bagging_tpu_torch.telemetry import perf, recorder  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    perf.disable()
    jperf.disable()
    yield
    perf.disable()
    jperf.disable()
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


@pytest.fixture(scope="module")
def clf():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(96, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    return BaggingClassifier(LogisticRegression(max_iter=3),
                             n_estimators=4, seed=0,
                             device="cpu").fit(X, y)


@pytest.fixture(scope="module")
def warmed_ex(clf):
    ex = EnsembleExecutor(clf, min_bucket_rows=8, max_batch_rows=32)
    ex.warmup()
    return ex


def _bd(total=10.0, queue=2.0, forward=6.0, batch=8.0,
        path="coalesced", **extra):
    bd = {"total_ms": total, "queue_ms": queue, "forward_ms": forward,
          "batch_ms": batch, "path": path, "batch_size": 1,
          "bucket": 8}
    bd.update(extra)
    return bd


_KINDS = ("serving_shard_failed", "serving_crash_loop", "serving_retry",
          "serving_bisect", "serving_batch_error", "serving_compile",
          "model_swapped", "swap_failed", "serving_overloaded",
          "tenant_quarantine_trip", "tenancy_restore", "flight_dump")


def _seeded_tail(seed: int):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(60):
        total = float(rng.uniform(1.0, 80.0))
        r = {"ts": float(rng.uniform(0.0, 30.0)), "trace_id": f"t{i}",
             "total_ms": None if rng.random() < 0.1 else total,
             "queue_ms": float(rng.uniform(0.0, total)),
             "forward_ms": float(rng.uniform(0.0, total)),
             "path": "direct" if rng.random() < 0.3 else "coalesced",
             "bucket": int(2 ** rng.integers(0, 9))}
        if rng.random() < 0.1:
            r["error"] = "RuntimeError('x')"
        if rng.random() < 0.1:
            r["tenant"] = f"t{int(rng.integers(0, 3))}"
            r["wfq_ms"] = float(rng.uniform(0.0, total))
            r["restore_ms"] = float(rng.choice([0.0, 3.0]))
        records.append(r)
    events = []
    for _ in range(40):
        kind = str(rng.choice(_KINDS))
        events.append({"kind": kind, "ts": float(rng.uniform(0.0, 30.0))})
    events.append({"kind": "span", "name": "serving_compile", "ts": 12.0})
    events.append({"kind": "span", "name": "quality_replica_compile",
                   "ts": 3.0})
    events.append({"kind": "span", "name": "serving_batch", "ts": 4.0})
    events.append({"kind": "tenancy_shed", "reason": "quarantine",
                   "ts": 20.0})
    events.append({"kind": "tenancy_shed", "reason": "overload",
                   "ts": 21.0})
    return records, events


@pytest.mark.parametrize("seed,window,threshold",
                         [(0, 1.0, None), (1, 0.3, 2.0), (2, 5.0, 10.0)])
def test_correlate_tail_verdicts_equal_jax(seed, window, threshold):
    records, events = _seeded_tail(seed)
    ours = perf.correlate_tail(records, events, window_s=window,
                               queue_threshold_ms=threshold)
    theirs = jperf.correlate_tail(records, events, window_s=window,
                                  queue_threshold_ms=threshold)
    assert ours == theirs
    assert len({o["verdict"] for o in ours}) >= 4
    assert perf.VERDICTS == jperf.VERDICTS


def _feed(mod, monkeypatch):
    """One seeded breakdown and forward stream into a fresh plane."""
    monkeypatch.setattr(mod.time, "time", lambda: 1234.5)
    plane = mod.PerfAttribution(refresh_every=16, slow_k=5, max_keys=4)
    rng = np.random.default_rng(7)
    for i in range(120):
        q, f = rng.uniform(0.01, 3.0, 2)
        batch = f + rng.uniform(0.0, 0.5)
        plane.observe_breakdown(
            _bd(total=float(q + batch), queue=float(q), forward=float(f),
                batch=float(batch),
                path=str(rng.choice(["direct", "coalesced"])),
                model_name=str(rng.choice(["m", "n", "o", "p", "q"])),
                model_version=int(rng.integers(1, 3))),
            trace_id=f"tr{i}")
        b = int(2 ** rng.integers(0, 5))
        cost = ({"flops": float(96 * b), "bytes": float(40 * b + 500)}
                if b != 16 else {"flops": None, "bytes": 1140.0})
        plane.observe_forward(b, int(rng.integers(1, b + 1)),
                              float(rng.uniform(1e-4, 1e-3)), cost)
    return plane


def test_summary_and_cost_model_equal_jax(monkeypatch):
    ours = _feed(perf, monkeypatch)
    theirs = _feed(jperf, monkeypatch)
    assert ours.cost_model() == theirs.cost_model()
    assert ours.summary() == theirs.summary()
    s = ours.summary()
    assert s["dropped_keys"] > 0 and s["peak_tflops_bf16"] is None
    assert s["cost_model"]["16"]["achieved_flops"] is None
    ours.export()
    theirs.export()
    pick = lambda reg: sorted(  # noqa: E731
        (e["name"], sorted(e["labels"].items()), e.get("value"))
        for e in reg.snapshot() if e["name"].startswith("sbt_perf_")
        and e["kind"] != "histogram")
    assert pick(telemetry.registry()) == pick(jtelemetry.registry())


# -- the JAX package's contracts ------------------------------------------

def test_shares_partition_the_wall_clock():
    p = perf.PerfAttribution(refresh_every=0)
    p.observe_breakdown(_bd(total=10, queue=2, forward=6, batch=8))
    p.observe_breakdown(_bd(total=20, queue=10, forward=8, batch=10))
    st = p.summary()["stages"]
    assert st["queue"]["seconds"] == pytest.approx(0.012)
    assert st["forward"]["seconds"] == pytest.approx(0.014)
    assert st["scatter"]["seconds"] == pytest.approx(0.004)
    assert sum(v["share"] for v in st.values()) == pytest.approx(1.0)


def test_key_cap_also_bounds_registry_series():
    p = perf.PerfAttribution(refresh_every=0, max_keys=2)
    for i in range(40):
        p.observe_breakdown(_bd(model_name=f"m{i}"))
    models = {e["labels"].get("model")
              for e in telemetry.registry().snapshot()
              if e["name"] == "sbt_perf_stage_seconds"}
    assert len(models) == 2
    assert p.summary()["dropped_keys"] == 38


def test_mfu_against_a_known_peak():
    p = perf.PerfAttribution(refresh_every=0)
    p._peak_tflops, p._peak_resolved = 100.0, True  # a card's peak
    p.observe_forward(8, 8, 0.001, {"flops": 5e9, "bytes": None})
    assert p.cost_model()["8"]["mfu"] == pytest.approx(0.05)
    p.export()
    assert telemetry.registry().gauge("sbt_perf_mfu").value == \
        pytest.approx(0.05)


def test_executor_probe_feeds_installed_plane_only(warmed_ex):
    X = np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32)
    warmed_ex.forward(X)  # no plane installed: nothing recorded
    plane = perf.enable(refresh_every=0)
    warmed_ex.forward(X)
    warmed_ex.forward(X[:4])
    cm = plane.cost_model()["8"]
    assert cm["forwards"] == 2 and cm["rows"] == 12 and cm["seconds"] > 0
    # the executor's counted FLOPs join the measured seconds
    assert cm["flops_per_forward"] == warmed_ex.bucket_costs[8]["flops"]
    assert cm["bytes_per_forward"] == warmed_ex.bucket_costs[8]["bytes"]
    assert cm["achieved_flops"] > 0 and cm["mfu"] is None  # the CPU


def test_batcher_probe_rides_the_breakdown(warmed_ex):
    X = np.random.default_rng(2).normal(size=(1, 6)).astype(np.float32)
    plane = perf.enable(refresh_every=0)
    with MicroBatcher(warmed_ex, max_delay_ms=1) as b:
        futs = [b.submit(X) for _ in range(12)]
        for f in futs:
            f.result(30)
    s = plane.summary()
    assert s["requests"] == 12
    for entry in s["by_key"]:
        shares = [v["share"] for v in entry["stages"].values()]
        assert abs(sum(shares) - 1.0) <= 1e-9, entry


def test_unarmed_probe_is_one_attribute_read(warmed_ex, monkeypatch):
    perf.disable()

    def boom(*a, **kw):  # pragma: no cover — must never run
        raise AssertionError("unarmed path touched the plane")

    monkeypatch.setattr(perf.PerfAttribution, "observe_forward", boom)
    monkeypatch.setattr(perf.PerfAttribution, "observe_breakdown", boom)
    X = np.ones((1, 6), np.float32)
    with MicroBatcher(warmed_ex, max_delay_ms=1) as b:
        b.submit(X).result(30)
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        ap = perf.ACTIVE
        if ap is not None:  # pragma: no cover — disabled
            raise AssertionError
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 2e-6, f"{per_call * 1e9:.0f}ns per probe"


def test_tail_report_joins_reservoir_with_flight_ring(warmed_ex):
    X = np.random.default_rng(3).normal(size=(4, 6)).astype(np.float32)
    plane = perf.enable(refresh_every=0)
    rec = recorder.FlightRecorder(capacity=64)
    rec.arm()
    try:
        with MicroBatcher(warmed_ex, max_delay_ms=1) as b:
            for _ in range(4):
                b.submit(X).result(30)
        report = perf.tail_report(limit=4, window_s=5.0)
    finally:
        rec.disarm()
    assert report["source"] == "perf-reservoir"
    assert len(report["tail"]) == 4
    assert all(r["verdict"] in perf.VERDICTS for r in report["tail"])
    totals = [r["total_ms"] for r in report["tail"]]
    assert totals == sorted(totals, reverse=True)
    assert set(report["stages"]) == {"queue", "forward", "scatter"}
    assert plane.summary()["requests"] == 4


def test_tail_report_falls_back_to_latency_exemplars():
    telemetry.observe("sbt_serving_latency_seconds", 0.05,
                      exemplar="tr-fast")
    telemetry.observe("sbt_serving_latency_seconds", 4.0,
                      exemplar="tr-slow")
    report = perf.tail_report(limit=4)
    assert report["source"] == "latency-exemplars"
    assert report["tail"][0]["trace_id"] == "tr-slow"
    assert perf.tail_report(limit=4)["perf_plane_active"] is False
