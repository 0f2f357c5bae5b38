"""Tenant blast-radius containment in the port, held against the JAX
package's: the fault-site table (every ``faults.fire`` site of the port
registered, every registered site live in the port but the three it has
no seam for), the quarantine machine (the same failure, admit and probe
streams give EQUAL events — seeded backoffs included — counts and
state documents in both packages), the unarmed tenancy paths never
calling ``faults.fire``, a killed demote leaving the tenant resident
with its programs, the quarantine telemetry/alert/debug surfaces, and
the in-process ``tenant-chaos`` drill: one tenant trips, is shed with
``TenantQuarantined``, probes and recovers, while every bystander's
outputs are bitwise those of the run without the plan and none of them
builds on a request (each build after warm-up belongs to a restore's
ladder).
"""

import ast
import functools
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from spark_bagging_tpu import tenancy as jtenancy  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.telemetry import workload as jworkload  # noqa: E402
from spark_bagging_tpu.telemetry.registry import (  # noqa: E402
    SERIES_HELP as JSERIES_HELP,
)
from spark_bagging_tpu_torch import (  # noqa: E402
    BaggingClassifier,
    LogisticRegression,
    faults,
    telemetry,
    tenancy,
)
from spark_bagging_tpu_torch.serving import ModelRegistry  # noqa: E402
from spark_bagging_tpu_torch.serving import program_cache as _pc  # noqa: E402
from spark_bagging_tpu_torch.tenancy import (  # noqa: E402
    AdmissionShed,
    QuarantineMachine,
    TenantFleet,
    TenantQuarantined,
    TenantSpec,
)

PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "spark_bagging_tpu_torch")

#: registered sites the port has no seam for: a CUDA graph cannot be
#: serialized, so there is no persisted executable cache to write or
#: read (``executor.mesh_forward`` fires on a mesh executor's slabs)
NO_SEAM = {"aot.save", "aot.load"}
TENANCY_SITES = ("residency.restore", "residency.demote_persist",
                 "fleet.dispatch", "wfq.pop", "budget.refit")


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    prev = _pc.install(_pc.ProgramCache(capacity=64))
    yield
    faults.disarm()
    tenancy.uninstall()
    _pc.install(prev)
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


def _counter(name, labels=None):
    return telemetry.registry().counter(name, labels=labels).value


def _problem(n=96, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    return X, (X @ w > 0).astype(np.int32)


def _fit(seed=0, n_estimators=2):
    X, y = _problem(seed=seed)
    return BaggingClassifier(LogisticRegression(max_iter=5),
                             n_estimators=n_estimators, seed=seed,
                             device="cpu").fit(X, y)


# -- the site table -------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _fired_sites() -> dict[str, list[str]]:
    """Every ``<anything>.fire("site", ...)`` call in the port (faults.py
    itself excluded), by site."""
    out: dict[str, list[str]] = {}
    for root, _, names in os.walk(PKG):
        for name in names:
            path = os.path.join(root, name)
            if not name.endswith(".py") or path == os.path.join(
                    PKG, "faults.py"):
                continue
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "fire" and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    out.setdefault(node.args[0].value, []).append(
                        os.path.relpath(path, PKG))
    return out


class TestSiteTable:
    def test_every_fired_site_is_registered(self):
        unknown = set(_fired_sites()) - set(faults.SITES)
        assert not unknown, unknown

    def test_every_registered_site_is_live_but_the_unported_seams(self):
        dead = set(faults.SITES) - set(_fired_sites())
        assert dead == NO_SEAM

    @pytest.mark.parametrize("site", TENANCY_SITES)
    def test_tenancy_sites_fire_in_the_tenancy_package(self, site):
        assert any(p.startswith("tenancy") for p in _fired_sites()[site])


# -- the quarantine machine ----------------------------------------------

def _drive_cycle(q, now=0.0):
    for i in range(3):
        tripped = q.record_failure("t1", now + i * 0.01, "dispatch")
    assert tripped
    return [e for e in q.events() if e["kind"] == "trip"][-1]


@pytest.mark.parametrize("seed", [0, 3, 111])
def test_quarantine_transcript_equals_jax(seed):
    """One seeded stream of failures, admits and probe verdicts through
    both packages' machines: equal verdicts, events (seeded, jittered
    backoffs included), counts and state."""
    rng = np.random.default_rng(seed)
    steps = [(f"t{int(rng.integers(0, 3))}", int(rng.integers(0, 4)),
              bool(rng.random() < 0.7)) for _ in range(300)]
    out = []
    for mod in (tenancy, jtenancy):
        q = mod.QuarantineMachine(["t0", "t1", "t2"], threshold=2,
                                  window_s=0.2, backoff_s=0.05, seed=seed)
        seen, now = [], 0.0
        for name, op, ok in steps:
            now += 0.01
            if op == 0:
                seen.append(q.record_failure(name, now, "dispatch"))
            else:
                try:
                    verdict = q.admit(name, now)
                except mod.TenantQuarantined as e:
                    seen.append(("shed", e.reason))
                    continue
                seen.append(verdict)
                if verdict == "probe":
                    if op == 3:
                        q.probe_aborted(name)
                    else:
                        seen.append(q.probe_result(name, now, ok))
        out.append((seen, q.events(), q.counts(), q.state()))
    assert out[0] == out[1]
    assert out[0][2]["trips"] and out[0][2]["recoveries"]


class TestQuarantineMachine:
    def test_trip_shed_probe_recover_cycle(self):
        q = QuarantineMachine(["t0", "t1"], threshold=3, window_s=1.0,
                              backoff_s=0.5, seed=0)
        trip = _drive_cycle(q)
        assert not q.healthy("t1") and q.healthy("t0")
        with pytest.raises(TenantQuarantined):
            q.admit("t1", trip["until"] - 1e-6)
        assert q.admit("t0", 0.1) == "healthy"
        t = trip["until"] + 0.01
        assert q.admit("t1", t) == "probe"
        with pytest.raises(TenantQuarantined):
            q.admit("t1", t)
        assert q.probe_result("t1", t, ok=True) is False
        assert q.healthy("t1")
        c = q.counts()
        assert c["trips"] == {"t1": 1} and c["recoveries"] == {"t1": 1}
        assert c["sheds"]["t1"] == 2 and c["probes"] == {"t1": 1}
        assert _counter("sbt_tenant_quarantine_shed_total") == 2.0
        assert _counter("sbt_tenancy_shed_total",
                        {"tenant": "t1", "reason": "quarantine"}) == 2.0

    def test_failed_probe_retrips_with_escalated_backoff(self):
        q = QuarantineMachine(["t1"], threshold=3, window_s=1.0,
                              backoff_s=0.5, backoff_factor=2.0, seed=3)
        first = _drive_cycle(q)
        t = first["until"] + 0.01
        assert q.admit("t1", t) == "probe"
        assert q.probe_result("t1", t, ok=False) is True
        second = [e for e in q.events() if e["kind"] == "trip"][-1]
        assert second["backoff_s"] > first["backoff_s"]
        assert not q.healthy("t1")

    def test_probe_aborted_keeps_the_deadline(self):
        q = QuarantineMachine(["t1"], threshold=3, seed=0)
        trip = _drive_cycle(q)
        t = trip["until"] + 0.01
        assert q.admit("t1", t) == "probe"
        q.probe_aborted("t1")
        assert q.admit("t1", t) == "probe"
        assert q.counts()["probes"] == {"t1": 2}
        assert q.counts()["trips"] == {"t1": 1}

    def test_window_prunes_stale_failures(self):
        q = QuarantineMachine(["t1"], threshold=3, window_s=0.5, seed=0)
        for t in (0.0, 0.2, 0.8, 0.85):
            assert not q.record_failure("t1", t, "dispatch")
        assert q.healthy("t1")
        assert q.record_failure("t1", 0.9, "dispatch")
        assert not q.healthy("t1")

    def test_unknown_tenant_and_bad_config_rejected(self):
        q = QuarantineMachine(["t1"], seed=0)
        with pytest.raises(KeyError, match="unknown tenant"):
            q.admit("ghost", 0.0)
        with pytest.raises(ValueError, match="threshold"):
            QuarantineMachine(["t1"], threshold=0)
        with pytest.raises(ValueError, match="backoff_factor"):
            QuarantineMachine(["t1"], backoff_factor=0.5)


# -- the unarmed hot path pays nothing ---------------------------------

class _Reg:
    """Executor stand-ins with the port's residency surface."""

    def executor(self, name):
        class _Ex:
            compiled_buckets = (8,)
            replica_buckets = ()
            quality = None
            device = torch.device("cpu")

            def release_programs(self):
                return (8,)

            def warmup(self, buckets=None):
                return tuple(buckets or ())

        return _Ex()


def test_unarmed_tenancy_paths_never_call_fire(monkeypatch):
    """With no plan armed, ``faults.fire`` is never called: patched to
    raise, the WFQ pop, the refit budgeter and a residency demote and
    restore round trip all run."""
    from spark_bagging_tpu_torch.tenancy import RefitBudgeter, WFQScheduler
    from spark_bagging_tpu_torch.tenancy.residency import ResidencyManager

    def boom(*a, **k):  # pragma: no cover — reaching it IS the failure
        raise AssertionError("faults.fire called while unarmed")

    monkeypatch.setattr(faults, "fire", boom)
    assert faults.ACTIVE is None
    wfq = WFQScheduler({"a": 2.0, "b": 1.0})
    wfq.enqueue("a", "x")
    assert wfq.pop() == ("a", "x")
    budget = RefitBudgeter([TenantSpec(name="a", weight=2.0),
                            TenantSpec(name="b")], total_per_window=2)
    assert budget.allow("a", now=0.0) is True
    r = ResidencyManager(_Reg(), capacity=1, aot_root=tempfile.mkdtemp())
    r.adopt("a")
    r.adopt("b")      # demotes "a"
    assert r.touch("a") == "restored"
    assert [e["kind"] for e in r.events()] == ["demote", "restore",
                                               "demote"]
    assert r.events()[1]["buckets"] == 1


def test_killed_demote_leaves_the_tenant_resident_and_serving():
    """A kill at ``residency.demote_persist`` fires before anything is
    released: the victim stays resident with its programs, unchanged
    answers, and its cache entries."""
    from spark_bagging_tpu_torch.tenancy.residency import ResidencyManager

    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    reg.register("a", _fit(seed=0), warmup=True)
    reg.register("b", _fit(seed=1), warmup=True)
    X = _problem(seed=4)[0][:5]
    before = reg.executor("a").forward(X)
    mgr = ResidencyManager(reg, capacity=1, aot_root=tempfile.mkdtemp())
    mgr.adopt("a")
    entries = len(_pc.cache())
    plan = faults.FaultPlan([{"site": "residency.demote_persist",
                              "action": "kill", "at": [1]}])
    with faults.armed(plan):
        with pytest.raises(faults.SimulatedKill):
            mgr.adopt("b")
    assert "a" in mgr.residents()
    assert reg.executor("a").compiled_buckets == (8, 16)
    assert len(_pc.cache()) == entries
    assert np.array_equal(reg.executor("a").forward(X), before)


# -- telemetry, alert rule, debug surface --------------------------------

class TestQuarantineSurfaces:
    def test_series_help_covers_the_tenancy_families_as_jax(self):
        from spark_bagging_tpu_torch.telemetry.registry import SERIES_HELP

        names = [k for k in JSERIES_HELP
                 if k.startswith(("sbt_tenancy_", "sbt_tenant_"))]
        assert len(names) == 19
        for name in names:
            assert SERIES_HELP[name] == JSERIES_HELP[name], name

    def test_flapping_rule_needs_two_trips_per_window(self):
        from spark_bagging_tpu_torch.telemetry import alerts

        rules = {r.name: r for r in alerts.default_capacity_rules(
            fast_window_s=2.0, slow_window_s=5.0, cooldown_s=0.0)}
        rule = rules["tenancy-quarantine-flapping"]
        assert rule.series == "sbt_tenant_quarantine_trips_total"
        eng = alerts.AlertEngine([rule])
        assert eng.evaluate(now=0.0) == []
        q = QuarantineMachine(["t1"], threshold=1, seed=0)
        q.record_failure("t1", 0.0, "dispatch")  # one real trip
        quiet = [e for t in (2.0, 4.0, 5.5, 7.0)
                 for e in eng.evaluate(now=t)]
        assert [e for e in quiet if e["kind"] == "alert_fired"] == []
        fired = []
        for i in range(1, 12):
            telemetry.inc("sbt_tenant_quarantine_trips_total", 2.0)
            fired += [e for e in eng.evaluate(now=7.0 + i / 2)
                      if e["kind"] == "alert_fired"]
        assert [e["rule"] for e in fired] == ["tenancy-quarantine-flapping"]

    def test_debug_tenancy_carries_quarantine_state(self):
        from spark_bagging_tpu_torch.telemetry.server import _debug_tenancy

        fleet = TenantFleet([TenantSpec(name="t0"), TenantSpec(name="t1")])
        tenancy.install(fleet)
        fleet.quarantine.record_failure("t1", 0.0, "dispatch")
        q = _debug_tenancy()["quarantine"]
        assert q["threshold"] == 3
        assert q["tenants"]["t1"]["state"] == "healthy"
        assert q["tenants"]["t1"]["failures"] == {"dispatch": 1}
        json.dumps(_debug_tenancy())


# -- the tenant-chaos drill, in process -----------------------------------

def _drill(models, plan=None):
    """The JAX drill's tenant-chaos shape (tests/test_tenant_chaos.py):
    6 tenants, residency for 4, Zipf 1.1, the 8..32 ladder, a Poisson
    schedule of 300 rps over 0.4 s; ``plan`` armed after warm-up."""
    names = [f"t{i}" for i in range(6)]
    specs = [TenantSpec(name=n, priority=tenancy.PRIORITY_CLASSES[i % 3],
                        weight=float(6 - i),
                        quota_rps=25.0 if i == 0 else None)
             for i, n in enumerate(names)]
    fleet = TenantFleet(
        specs, registry=ModelRegistry(min_bucket_rows=8, max_batch_rows=32),
        residency_capacity=4, aot_root=tempfile.mkdtemp(),
        quarantine_window_s=0.25, quarantine_backoff_s=0.05,
        quarantine_seed=111,
        batcher_opts=dict(max_delay_ms=2.0, idle_flush_ms=1.0,
                          max_batch_rows=256))
    for name, model in zip(names, models):
        fleet.register(name, model, version=1)
    reqs = jworkload.synthetic_workload(
        "poisson", rate_rps=300.0, duration_s=0.4, seed=111, width=8,
        bucket_bounds=(8, 32)).requests
    p = np.arange(1, 7, dtype=np.float64) ** -1.1
    owner = np.random.default_rng(111).choice(6, size=len(reqs),
                                              p=p / p.sum())
    pool = np.random.default_rng(111).normal(size=(1024, 8)).astype(
        np.float32)
    c0 = {n: _counter("sbt_serving_compiles_total", {"model": n})
          for n in names}
    futs, shed = {}, []
    pending = {n: [] for n in names}
    if plan is not None:
        faults.arm(plan)
    try:
        i = 0
        while i < len(reqs):
            vt, window = reqs[i].t, []
            while i < len(reqs) and reqs[i].t <= vt + 0.002:
                window.append(i)
                i += 1
            for idx in window:
                name = names[int(owner[idx])]
                try:
                    fleet.submit(name, pool[idx % 900:idx % 900
                                            + reqs[idx].rows], now=vt)
                    pending[name].append(idx)
                except AdmissionShed as e:
                    shed.append((name, e.reason))
            for rec in fleet.dispatch(now=vt):
                idx = pending[rec["tenant"]].pop(0)
                if rec["future"] is not None:
                    futs[idx] = (rec["tenant"], rec["future"])
    finally:
        faults.disarm()
    builds = {n: _counter("sbt_serving_compiles_total", {"model": n}) - c0[n]
              for n in names}
    restored = {n: sum(e.get("buckets", 0) for e in fleet.residency.events()
                       if e["kind"] == "restore" and e["tenant"] == n)
                for n in names}
    tenancy.install(fleet)
    try:
        from spark_bagging_tpu_torch.telemetry.server import _debug_tenancy

        debug = _debug_tenancy()
    finally:
        tenancy.uninstall()
    out = {idx: (t, f.result(10)) for idx, (t, f) in futs.items()}
    fleet.close()
    return dict(out=out, shed=shed, builds=builds, restored=restored,
                quarantine=fleet.quarantine.counts(),
                downstream=fleet.shed_counts(), debug=debug)


def test_tenant_chaos_drill_contains_the_blast_radius():
    models = [_fit(seed=111 + i) for i in range(6)]
    control = _drill(models)
    plan = faults.builtin_plan("tenant-chaos", seed=111)
    chaos = _drill(models, plan)
    snap = plan.snapshot()
    assert snap["fired_total"] == 3  # aot.load has no probe here
    assert chaos["quarantine"]["trips"] == {"t1": 1}
    assert chaos["quarantine"]["recoveries"] == {"t1": 1}
    assert chaos["downstream"] == {"t1": {"fault": 3}}
    q_sheds = [s for s in chaos["shed"] if s[1] == "quarantine"]
    assert q_sheds and {s[0] for s in q_sheds} == {"t1"}
    # bystanders: the same requests served, bitwise the same answers
    for idx, (tenant, out) in control["out"].items():
        if tenant != "t1":
            assert np.array_equal(chaos["out"][idx][1], out), idx
    assert {i for i, (t, _) in chaos["out"].items() if t != "t1"} == \
        {i for i, (t, _) in control["out"].items() if t != "t1"}
    # no build on a request: each one after warm-up is a restore's
    for run in (control, chaos):
        assert run["builds"] == run["restored"]
    assert sum(control["restored"].values()) > 0
    t1 = chaos["debug"]["quarantine"]["tenants"]["t1"]
    assert t1["trips"] == 1 and t1["recoveries"] == 1
    assert t1["failures"] == {"dispatch": 3}
