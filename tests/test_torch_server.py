"""The exposition server, the SLO gate, the history store, the telemetry
CLI and the builtin chaos plans in the port, held against the JAX
package's:

- ``render_prometheus`` of one snapshot (the capacity, performance,
  fleet, history, process and fit series, whose help text is copied
  verbatim) is byte-identical;
- ``dump --merge --no-quantiles`` over the same two JSONL capture logs
  prints byte-identical output;
- ``slo.evaluate`` and ``compare_to_baseline`` give the same checks on
  seeded reports;
- a ``history.jsonl`` written by either package reads back in the
  other with an equal ``compare_trend``;
- ``builtin_plan_spec`` is equal for every name;
- ``/debug/tenancy`` answers as the JAX package does with no tenant
  fleet installed;

and the JAX package's server contracts, copied: the routes answer over
real HTTP during serving traffic; ``/healthz`` is 200 while serving,
503 once a batcher is closed, and a retired batcher leaves it; a
collected health source disappears and a broken one reports 503; the
``SBT_METRICS_PORT`` opt-in (a fresh import leaves ``server.py``
unimported without it) and a bad port warns; ``/debug/profile``'s
single-flight guard against a fake profiler. Every server binds
``127.0.0.1:0`` and every HTTP call has a timeout.
"""

import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from spark_bagging_tpu import faults as jfaults  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.telemetry import history as jhistory  # noqa: E402
from spark_bagging_tpu.telemetry import server as jserver  # noqa: E402
from spark_bagging_tpu.telemetry import slo as jslo  # noqa: E402
from spark_bagging_tpu.telemetry.__main__ import main as jmain  # noqa: E402
from spark_bagging_tpu_torch import (  # noqa: E402
    BaggingClassifier,
    LogisticRegression,
    faults,
    telemetry,
)
from spark_bagging_tpu_torch.serving import ModelRegistry  # noqa: E402
from spark_bagging_tpu_torch.telemetry import history, slo  # noqa: E402
from spark_bagging_tpu_torch.telemetry import server as tserver  # noqa: E402
from spark_bagging_tpu_torch.telemetry.__main__ import main  # noqa: E402
from spark_bagging_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(port: int, path: str):
    """(status, body) — never raises on HTTP error codes."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    tserver.clear_health_sources()
    yield
    tserver.stop_server()
    profiling.stop_profile()
    telemetry.recorder.disarm()
    tserver.clear_health_sources()
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


@pytest.fixture(scope="module")
def clf():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(96, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    clf = BaggingClassifier(LogisticRegression(max_iter=3), n_estimators=4,
                            seed=0, device="cpu").fit(X, y)
    clf._test_X = X
    return clf


# -- parity with the JAX package ----------------------------------------

#: series whose # HELP lines the port copies verbatim
_VERBATIM = ("sbt_fleet_peers", "sbt_capacity_demand_requests_total",
             "sbt_perf_stage_seconds", "sbt_perf_mfu",
             "sbt_history_appends_total", "sbt_process_rss_bytes",
             "sbt_serving_flops_total", "sbt_program_cache_bytes",
             "sbt_replicas_fitted_total", "sbt_serving_requests_total",
             "sbt_serving_latency_seconds", "sbt_serving_queue_depth")


def _feed(t, n: float) -> None:
    t.inc("sbt_serving_requests_total", n)
    t.inc("sbt_capacity_demand_requests_total", n, labels={"model": "m"})
    t.inc("sbt_replicas_fitted_total", 2 * n)
    t.inc("sbt_history_appends_total")
    t.inc("sbt_serving_flops_total", 123.5 * n)
    t.set_gauge("sbt_fleet_peers", 2.0)
    t.set_gauge("sbt_perf_mfu", 0.0125 * n)
    t.set_gauge("sbt_process_rss_bytes", 1e9 + n)
    t.set_gauge("sbt_program_cache_bytes", 4096.0 * n)
    t.set_gauge("sbt_serving_queue_depth", n)
    rng = np.random.default_rng(int(n))
    for v in rng.lognormal(-4, 1.5, 50):
        t.observe("sbt_serving_latency_seconds", float(v))
        t.observe("sbt_perf_stage_seconds", float(v) / 3,
                  labels={"stage": "queue", "path": "direct"})


def test_verbatim_help_and_render_prometheus_byte_identical():
    for name in _VERBATIM:
        assert telemetry.SERIES_HELP[name] == jtelemetry.SERIES_HELP[name]
    _feed(telemetry, 3.0)
    _feed(jtelemetry, 3.0)
    ours = telemetry.registry().snapshot()
    theirs = jtelemetry.registry().snapshot()
    assert telemetry.render_prometheus(ours) == \
        jtelemetry.render_prometheus(theirs)
    # and either package renders the other's snapshot the same
    assert telemetry.render_prometheus(theirs) == \
        jtelemetry.render_prometheus(ours)


def _logs(tmp_path):
    paths = []
    for name, n in (("peer_a", 2.0), ("peer_b", 5.0)):
        telemetry.reset()
        path = tmp_path / f"{name}.jsonl"
        with telemetry.capture(str(path)):
            _feed(telemetry, n)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("quantiles", [False, True])
def test_dump_merge_output_equals_jax(tmp_path, quantiles):
    paths = _logs(tmp_path)
    args = ["dump", "--merge", *paths]
    if not quantiles:
        args.append("--no-quantiles")
    outs = []
    for m in (main, jmain):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert m(list(args)) == 0
        outs.append(buf.getvalue())
    if quantiles:
        # the quantile comments are the same log-bucket estimates
        assert outs[0].count("# quantiles") == outs[1].count("# quantiles")
    else:
        assert outs[0] == outs[1]
    assert "sbt_serving_requests_total 7" in outs[0]
    assert 'sbt_serving_queue_depth{fleet="sum"} 7' in outs[0]


def _reports(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(12):
        rep = {
            "latency_ms": {q: float(v) for q, v in zip(
                ("p50", "p95", "p99"),
                np.sort(rng.uniform(0.1, 60.0, 3)))},
            "rps": float(rng.uniform(100, 5000)),
            "padding": ({"waste_flops_frac": float(rng.uniform(0, 0.5))}
                        if rng.random() < 0.5 else
                        {"waste_rows_frac": float(rng.uniform(0, 0.5))}),
            "overloads": int(rng.integers(0, 3)),
            "post_warmup_compiles": int(rng.integers(0, 2)),
            "attribution": {"stages": {
                s: {"share": float(rng.uniform(0, 1))}
                for s in ("queue", "forward", "scatter")}},
            "workload_digest": "w", "seed": 1, "batcher": {"d": 1},
            "output_digest": str(rng.choice(["a", "b"])),
        }
        if rng.random() < 0.2:
            del rep["rps"]
        out.append(rep)
    return out


def test_slo_evaluate_and_compare_to_baseline_equal_jax():
    spec = dict(p50_ms=5.0, p95_ms=30.0, p99_ms=50.0, min_rps=500.0,
                max_padding_waste=0.3, max_overloads=1,
                max_post_warmup_compiles=0,
                max_stage_share={"queue": 0.6})
    s_ours, s_theirs = slo.SLOSpec(**spec), jslo.SLOSpec(**spec)
    assert s_ours.to_dict() == s_theirs.to_dict()
    reports = _reports(3)
    for rep, base in zip(reports, reports[1:] + reports[:1]):
        a, b = slo.evaluate(s_ours, rep), jslo.evaluate(s_theirs, rep)
        assert a.to_dict() == b.to_dict()
        assert slo.exit_code(a) == jslo.exit_code(b)
        assert a.render() == b.render()
        a = slo.compare_to_baseline(rep, base)
        b = jslo.compare_to_baseline(rep, base)
        assert a.to_dict() == b.to_dict()


def _history_runs(mod, path):
    rng = np.random.default_rng(9)
    for i in range(8):
        mod.append_record(
            "bench", "planes",
            digests={"outputs": "x" if i != 6 else "y"},
            numbers={"rps": float(1000 + rng.uniform(-50, 50)),
                     "p99_ms": float(rng.uniform(2, 3)) * (1 + (i == 7))},
            slo_ok=i != 5, ts=1000.0 + i, run_id=f"r{i}", path=path)
    mod.append_record("tier", "t1", numbers={"seconds": 316.0},
                      ts=2000.0, run_id="tier-1", path=path)


def test_history_cross_reads_with_equal_trend(tmp_path):
    ours_p, theirs_p = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    _history_runs(history, ours_p)
    _history_runs(jhistory, theirs_p)
    with open(ours_p) as a, open(theirs_p) as b:
        assert a.read() == b.read()  # the same bytes on disk
    for reader, writer in ((history, theirs_p), (jhistory, ours_p)):
        recs = reader.read_history(path=writer)
        assert len(recs) == 9
    t_ours = history.compare_trend(jhistory.read_history(path=ours_p))
    t_theirs = jhistory.compare_trend(history.read_history(path=theirs_p))
    assert t_ours == t_theirs
    assert not t_ours["ok"] and len(t_ours["flips"]) >= 2
    rep = history.history_report(limit=3, path=ours_p)
    assert history.render_history(rep) == jhistory.render_history(
        jhistory.history_report(limit=3, path=ours_p))


def test_builtin_plans_equal_jax():
    names = ("blips", "poison", "mixed", "shard-loss", "worker-crash",
             "crash-loop", "peer-loss", "tenant-chaos")
    for name in names:
        for seed in (0, 7):
            assert faults.builtin_plan_spec(name, seed) == \
                jfaults.builtin_plan_spec(name, seed)
            assert faults.builtin_plan(name, seed).digest() == \
                jfaults.builtin_plan(name, seed).digest()
    with pytest.raises(ValueError, match="unknown builtin chaos plan"):
        faults.builtin_plan_spec("nope")


def test_debug_tenancy_answers_as_jax_without_a_fleet():
    assert tserver._debug_tenancy() == jserver._debug_tenancy()


# -- the server's contracts ---------------------------------------------

def test_routes_answer_during_live_serving_traffic(clf):
    X = clf._test_X
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=32)
    reg.register("m", clf, warmup=True)
    port = tserver.start_server(0)
    assert tserver.start_server(0) == port  # idempotent
    assert tserver.server_address() == ("127.0.0.1", port)
    with reg.batcher("m", max_delay_ms=1) as b:
        futs = [b.submit(X[i:i + 1]) for i in range(24)]
        for f in futs:
            f.result(30)
        code, body = _get(port, "/healthz")
        assert code == 200
        report = json.loads(body)
        assert any(k.startswith("model_registry") for k in report["sources"])
        assert any(k.startswith("batcher") for k in report["sources"])
        code, metrics = _get(port, "/metrics")
        assert code == 200 and "sbt_serving_requests_total" in metrics
        assert "sbt_process_rss_bytes" in metrics
        assert "sbt_process_device_bytes_in_use" not in metrics  # the CPU
        code, body = _get(port, "/varz")
        varz = json.loads(body)
        assert varz["rss_bytes"] > 0 and varz["uptime_seconds"] >= 0
        for path in ("/debug/spans", "/debug/runs", "/debug/workload",
                     "/debug/drift", "/debug/tail", "/debug/history",
                     "/debug/capacity", "/debug/tenancy", "/alerts", "/"):
            code, body = _get(port, path)
            assert code == 200, path
            json.loads(body)
        assert _get(port, "/fleet/varz")[0] == 404
        assert _get(port, "/nope")[0] == 404
    # the batcher is closed: the drain signal
    assert _get(port, "/healthz")[0] == 503
    tserver.stop_server()
    assert tserver.server_address() is None


def test_retire_leaves_healthz_while_close_poisons_it(clf):
    X = clf._test_X
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=32)
    reg.register("m", clf, warmup=False)
    old = reg.batcher("m", max_delay_ms=2, max_queue=16)
    old.submit(X[:2]).result(30)
    old.retire()  # close + leave /healthz
    fresh = reg.batcher("m", max_delay_ms=2, max_queue=16)
    try:
        report = tserver.health_report()
        assert report["healthy"] is True
        assert len([k for k in report["sources"]
                    if k.startswith("batcher")]) == 1
    finally:
        fresh.close()
    assert tserver.health_report()["healthy"] is False


def test_dead_and_broken_health_sources():
    import gc

    class Box:
        def health(self):
            return {"healthy": False}

    box = Box()
    tserver.register_health_source("box", box, Box.health)
    assert tserver.health_report()["healthy"] is False
    del box
    gc.collect()
    assert tserver.health_report() == {"healthy": True, "sources": {}}

    class Bad:
        def health(self):
            raise RuntimeError("probe broke")

    bad = Bad()
    tserver.register_health_source("bad", bad, Bad.health)
    port = tserver.start_server(0)
    code, body = _get(port, "/healthz")
    assert code == 503
    (detail,) = json.loads(body)["sources"].values()
    assert "probe broke" in detail["error"]


def test_env_opt_in_and_bad_port_warns(monkeypatch):
    monkeypatch.delenv("SBT_METRICS_PORT", raising=False)
    assert tserver.maybe_start_from_env() is None
    assert tserver.server_address() is None
    monkeypatch.setenv("SBT_METRICS_PORT", "0")
    port = tserver.maybe_start_from_env()
    assert port is not None and _get(port, "/metrics")[0] == 200
    tserver.stop_server()
    monkeypatch.setenv("SBT_METRICS_PORT", "not-a-port")
    with pytest.warns(RuntimeWarning, match="failed to start"):
        assert tserver.maybe_start_from_env() is None


def test_fresh_import_leaves_the_server_unimported():
    code = ("import sys, spark_bagging_tpu_torch as T, torch; "
            "print('spark_bagging_tpu_torch.telemetry.server' in "
            "sys.modules, T.telemetry.server_address() is not None "
            "if 'spark_bagging_tpu_torch.telemetry.server' in sys.modules "
            "else False, torch.cuda.is_initialized())")
    env = {k: v for k, v in os.environ.items() if k != "SBT_METRICS_PORT"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "False"], out.stderr
    env["SBT_METRICS_PORT"] = "0"
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "True", "False"], out.stderr


class _FakeProfile:
    """Stand-in for ``torch.profiler.profile``: the single-flight
    contract without a real capture."""

    started: list = []
    stopped: list = []

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def start(self):
        _FakeProfile.started.append(self)

    def stop(self):
        _FakeProfile.stopped.append(self)

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            f.write("{}")


def test_debug_profile_single_flight_against_a_fake_profiler(
        tmp_path, monkeypatch):
    monkeypatch.setenv("SBT_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    _FakeProfile.started, _FakeProfile.stopped = [], []
    port = tserver.start_server(0)
    code, body = _get(port, "/debug/profile?seconds=30")
    body = json.loads(body)
    assert code == 200 and body["started"] is True
    assert body["view"].endswith("trace.json")
    code, busy = _get(port, "/debug/profile?seconds=1")
    assert code == 409 and json.loads(busy)["active"]["dir"] == body["dir"]
    assert telemetry.registry().counter(
        "sbt_profile_rejected_total").value == 1
    code, stopped = _get(port, "/debug/profile?action=stop")
    assert code == 200 and json.loads(stopped)["stopped"] is True
    assert os.path.exists(os.path.join(body["dir"], "trace.json"))
    assert _get(port, "/debug/profile?action=stop")[0] == 200
    assert _get(port, "/debug/profile?seconds=bogus")[0] == 400
    assert _get(port, "/debug/profile?seconds=-1")[0] == 400
    assert _get(port, "/debug/profile?action=x")[0] == 400
    assert len(_FakeProfile.started) == len(_FakeProfile.stopped) == 1
    # the CLI drives the same route
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["profile", "--seconds", "30", "--port",
                     str(port)]) == 0
    assert json.loads(buf.getvalue())["started"] is True
    assert main(["profile", "--seconds", "1", "--port", str(port)]) == 1
    with redirect_stdout(io.StringIO()):
        assert main(["profile", "--stop", "--port", str(port)]) == 0
