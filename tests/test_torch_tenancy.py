"""The tenancy plane of the port, held against the JAX package's:

- policy parity: the same spec lists and seeded request streams through
  both packages' ``AdmissionController``, ``WFQScheduler`` and
  ``RefitBudgeter`` give EQUAL decisions, pressure levels, pop orders,
  service totals, allow/deny counts and state documents;
- the stepped fleet: both packages' ``TenantFleet`` over the same seeded
  workload (3 tenants, residency for 2, the 8..32 ladder) give the same
  residency transcript, WFQ pop order, admission and budget counts, and
  outputs within the serving tests' tolerance;
- the port's ``release_programs`` drops its cache entries as the JAX
  package's does (ROADMAP Queue C, C4): the eviction counters read
  2.0 in both, labelled by owner;
- the journey identity: admission + wfq + dispatch + restore + queue +
  batch == total for every served request, restores included;

and the JAX package's contract tests, copied: WFQ fairness, admission's
quotas and shed order, the refit budget and its trainer hook, the pin
policy, the demote/restore round trip (on the CPU a restore re-runs the
eager build, so its captures are builds: counted, equal to the recorded
ladder, and the answer bitwise that of a never-demoted solo executor),
the tenancy alert rules, ``/debug/tenancy`` and the lock order.
"""

import json
import tempfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
from benchmarks.replay import plan_windows  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu import tenancy as jtenancy  # noqa: E402
from spark_bagging_tpu.telemetry import workload as jworkload  # noqa: E402
from spark_bagging_tpu_torch import telemetry, tenancy  # noqa: E402
from spark_bagging_tpu_torch.serving import ModelRegistry  # noqa: E402
from spark_bagging_tpu_torch.serving import program_cache as _pc  # noqa: E402
from spark_bagging_tpu_torch.telemetry import alerts  # noqa: E402
from spark_bagging_tpu_torch.telemetry import capacity as capacity_mod  # noqa: E402
from spark_bagging_tpu_torch.tenancy import (  # noqa: E402
    AdmissionController,
    AdmissionShed,
    QuotaExceeded,
    RefitBudgeter,
    TenantFleet,
    TenantSpec,
    WFQScheduler,
)

# soft votes from two frameworks' float32 products (test_torch_serving)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean():
    from spark_bagging_tpu.serving import program_cache as jpc

    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    prev = _pc.install(_pc.ProgramCache(capacity=64))
    jprev = jpc.install(jpc.ProgramCache(capacity=64))
    yield
    _pc.install(prev)
    jpc.install(jprev)
    tenancy.uninstall()
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


def _counter(name, labels=None, pkg=telemetry):
    return pkg.registry().counter(name, labels=labels).value


def _problem(n=96, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = (X @ w > 0).astype(np.int32)
    return X, y


def _fit(seed=0, n_estimators=2, pkg=T):
    X, y = _problem(seed=seed)
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.BaggingClassifier(
        base_learner=pkg.LogisticRegression(max_iter=5),
        n_estimators=n_estimators, seed=seed, **kw,
    ).fit(X, y)


# -- policy parity with the JAX package --------------------------------

def _specs(mod, n=4):
    return [mod.TenantSpec(name=f"t{i}",
                           priority=mod.PRIORITY_CLASSES[i % 3],
                           weight=float(n - i),
                           quota_rps=5.0 if i == 0 else None,
                           quota_rows_ps=40.0 if i == 1 else None)
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_equal_jax(seed):
    """One seeded stream of admits and downstream overloads: every
    decision, pressure level and the final state document equal."""
    rng = np.random.default_rng(seed)
    ctls = [mod.AdmissionController(_specs(mod), pressure_window_s=0.3,
                                    escalate_after=2)
            for mod in (tenancy, jtenancy)]
    transcripts = [[], []]
    now = 0.0
    steps = [(int(rng.integers(0, 4)), int(rng.integers(1, 9)),
              float(rng.exponential(0.02)), bool(rng.random() < 0.05))
             for _ in range(400)]
    for k, ctl in enumerate(ctls):
        now = 0.0
        for tenant, rows, dt, overload in steps:
            now += dt
            if overload:
                ctl.observe_overload(now)
            transcripts[k].append((ctl.admit(f"t{tenant}", rows, now),
                                   ctl.pressure_level(now)))
        transcripts[k].append(ctl.state(now=now))
        transcripts[k].append((ctl.admitted_counts(), ctl.shed_counts()))
    assert transcripts[0] == transcripts[1]
    reasons = {r for r, _ in transcripts[0][:-2]}
    assert {"quota", "priority", None} <= reasons


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wfq_pop_order_and_totals_equal_jax(seed):
    rng = np.random.default_rng(seed)
    weights = {"a": 3.0, "b": 1.5, "c": 1.0, "d": 0.25}
    ops = [(str(rng.choice(list(weights))), float(rng.integers(1, 9)),
            bool(rng.random() < 0.4)) for _ in range(300)]
    out = []
    for mod in (tenancy, jtenancy):
        wfq = mod.WFQScheduler(weights)
        seen = []
        for i, (t, cost, pop) in enumerate(ops):
            seen.append(wfq.enqueue(t, i, cost=cost))
            if pop and len(wfq):
                seen.append(wfq.pop())
        seen += list(wfq.drain())
        out.append((seen, wfq.service_totals(), wfq.state()))
    assert out[0] == out[1]


def test_refit_budget_decisions_equal_jax():
    rng = np.random.default_rng(5)
    steps = [(f"t{int(rng.integers(0, 4))}", float(i) * 0.07,
              int(rng.integers(0, 12))) for i in range(200)]
    out = []
    for mod in (tenancy, jtenancy):
        b = mod.RefitBudgeter(_specs(mod), total_per_window=5,
                              window_s=1.0)
        seen = []
        for name, now, op in steps:
            if op == 0:
                b.release(name)
            elif op == 1:
                b.readmit(name)
            seen.append((b.allow(name, now), b.quota(name)))
        out.append((seen, b.counts(), b.state()))
    assert out[0] == out[1]
    assert out[0][1]["denied"] and out[0][1]["allowed"]


# -- the stepped fleet against the JAX package's -----------------------

def _relowering_restore(executor, path):
    """The JAX package's executable restore for the reference run,
    replaced by a lowering of the persisted ladder: on the tests' 8-device
    CPU mesh its deserialized executables expect 8 shards and raise (as
    tests/test_journey.py's restore does). The residency transcript sees
    the same restored buckets."""
    from spark_bagging_tpu.serving.aot_cache import MANIFEST

    with open(f"{path}/{MANIFEST}") as f:
        buckets = sorted(int(b) for b in json.load(f)["buckets"])
    executor.warmup(buckets)
    return tuple(buckets)


def _drive_fleet(pkg, models, *, n_tenants=3, capacity=2, seed=110):
    """The JAX drill's stepped drive (benchmarks/replay.py
    replay_tenants), reduced to its transcript: one fresh private plane
    and pin-policy cache, Zipf routing, windows on the virtual clock."""
    import importlib

    root = pkg.__name__
    serving = importlib.import_module(root + ".serving")
    pc = importlib.import_module(root + ".serving.program_cache")
    cap = importlib.import_module(root + ".telemetry.capacity")
    ten = importlib.import_module(root + ".tenancy")
    res = importlib.import_module(root + ".tenancy.residency")
    wl = jworkload.synthetic_workload(
        "poisson", rate_rps=150.0, duration_s=0.3, seed=110, width=8,
        bucket_bounds=(8, 32))
    reqs = wl.requests
    p = np.arange(1, n_tenants + 1, dtype=np.float64) ** -1.1
    owner = np.random.default_rng(seed).choice(n_tenants, size=len(reqs),
                                               p=p / p.sum())
    names = [f"t{i}" for i in range(n_tenants)]
    specs = [ten.TenantSpec(name=names[i],
                            priority=ten.PRIORITY_CLASSES[i % 3],
                            weight=float(n_tenants - i),
                            quota_rps=25.0 if i == 0 else None)
             for i in range(n_tenants)]
    plane = cap.CapacityPlane(hot_rps=50.0, warm_rps=20.0)
    prev_plane = cap.install(plane)
    prev_cache = pc.install(pc.ProgramCache(
        capacity=16, pin_policy=res.cache_pin_policy(plane)))
    pool = np.random.default_rng(seed).normal(size=(1024, 8)).astype(
        np.float32)
    rows_max = max(r.rows for r in reqs)
    try:
        fleet = ten.TenantFleet(
            specs, registry=serving.ModelRegistry(min_bucket_rows=8,
                                                  max_batch_rows=32),
            residency_capacity=capacity, aot_root=tempfile.mkdtemp(),
            plane=plane, refit_total_per_window=4, refit_window_s=0.25,
            quarantine_window_s=0.25, quarantine_backoff_s=0.05,
            quarantine_seed=seed,
            batcher_opts=dict(max_delay_ms=2.0, idle_flush_ms=1.0,
                              max_batch_rows=256, max_queue=1024))
        for name, model in zip(names, models):
            fleet.register(name, model, warmup=True, version=1)
        futs, order, budget = {}, [], []
        pending = {n: [] for n in names}
        for w_i, window in enumerate(plan_windows(
                reqs, max_delay_s=0.002, idle_flush_s=0.001)):
            vt = reqs[window[0]].t
            for idx in window:
                name = names[int(owner[idx])]
                start = (idx * 131) % (1024 - rows_max + 1)
                try:
                    fleet.submit(name, pool[start:start + reqs[idx].rows],
                                 now=vt)
                    pending[name].append(idx)
                except ten.AdmissionShed:
                    pass
            drained = fleet.dispatch(now=vt)
            order.append([r["tenant"] for r in drained])
            for r in drained:
                idx = pending[r["tenant"]].pop(0)
                if r["future"] is not None:
                    futs[idx] = r["future"]
            if w_i % 8 == 0:
                budget.append(fleet.refit_allowed("t0", vt))
        outputs = {i: np.asarray(f.result(10)) for i, f in futs.items()}
        transcript = dict(
            order=order, events=fleet.residency.events(),
            counts=fleet.residency.counts(),
            residents=fleet.residency.residents(),
            admitted=fleet.admission.admitted_counts(),
            sheds=fleet.admission.shed_counts(),
            wfq=fleet.wfq.service_totals(), served=fleet.served_rows(),
            budget=(budget, fleet.budget.counts()),
            evictions=plane.eviction_counts(),
            reconciled=plane.ledger()["reconciled"])
        fleet.close()
    finally:
        pc.install(prev_cache)
        cap.install(prev_plane)
    return transcript, outputs


def test_stepped_fleet_transcript_equals_jax(monkeypatch):
    from spark_bagging_tpu.serving import aot_cache

    port_models = [_fit(seed=110 + i) for i in range(3)]
    jax_models = [_fit(seed=110 + i, pkg=J) for i in range(3)]
    ours, out = _drive_fleet(T, port_models)
    monkeypatch.setattr(aot_cache, "restore_executables",
                        _relowering_restore)
    theirs, jout = _drive_fleet(J, jax_models)
    assert ours == theirs
    assert ours["counts"]["restores"] and ours["counts"]["demotions"]
    assert sorted(out) == sorted(jout) and len(out) > 20
    for i in out:
        np.testing.assert_allclose(out[i], jout[i], **TOL)


# -- C4: release_programs drops its cache entries, as JAX does ----------

def test_release_programs_counts_evictions_as_jax():
    """The port's release_programs drops this fingerprint's unified-cache
    entries while it still holds them, charged to the owner through the
    capacity plane: 2.0 evictions for buckets (8, 16), in both
    packages (the port counted 0.0 before)."""
    from spark_bagging_tpu.serving import ModelRegistry as JRegistry
    from spark_bagging_tpu.telemetry import capacity as jcapacity

    got = []
    for pkg, Reg, cap, model in (
            (telemetry, ModelRegistry, capacity_mod, _fit()),
            (jtelemetry, JRegistry, jcapacity, _fit(pkg=J))):
        prev = cap.install(cap.CapacityPlane())
        try:
            reg = Reg(min_bucket_rows=8, max_batch_rows=16)
            reg.register("m", model, warmup=True)
            released = reg.executor("m").release_programs()
            got.append((released,
                        _counter("sbt_program_cache_evictions_total",
                                 pkg=pkg),
                        _counter("sbt_program_cache_evictions_total",
                                 {"model": "m"}, pkg=pkg),
                        _counter("sbt_serving_programs_released_total",
                                 pkg=pkg)))
        finally:
            cap.install(prev)
    assert got[0] == got[1] == ((8, 16), 2.0, 2.0, 2.0)


# -- the journey identity ----------------------------------------------

def test_journey_stages_tile_the_total():
    """admission + wfq + dispatch + restore + queue + batch == total for
    every served request, with restores (capacity 1 over two tenants)
    carved out of the queue wait they happened in."""
    specs = [TenantSpec(name="t0"), TenantSpec(name="t1", weight=2.0)]
    fleet = TenantFleet(specs, registry=ModelRegistry(min_bucket_rows=8,
                                                      max_batch_rows=16),
                        residency_capacity=1, aot_root=tempfile.mkdtemp())
    fleet.register("t0", _fit(seed=0))
    fleet.register("t1", _fit(seed=1))
    X = _problem(seed=3)[0]
    futs = []
    for step in range(12):
        for k in range(1 + step % 3):
            fleet.submit(f"t{(step + k) % 2}", X[k:k + 1 + step % 4],
                         now=step * 0.01)
        futs += [r["future"] for r in fleet.dispatch(now=step * 0.01)]
    restored = 0
    for fut in futs:
        fut.result(10)
        bd = fut.trace.breakdown
        parts = sum(bd[k] for k in ("admission_ms", "wfq_ms",
                                    "dispatch_ms", "restore_ms",
                                    "queue_ms", "batch_ms"))
        assert abs(parts - bd["total_ms"]) <= 1e-6, bd
        assert bd["tenant"] in ("t0", "t1")
        restored += bd["restore_ms"] > 0
    assert restored > 0
    assert sum(fleet.residency.counts()["restores"].values()) > 0
    fleet.close()


# -- the JAX package's contract tests, copied ---------------------------

class TestTenantSpec:
    def test_validation(self):
        with pytest.raises(ValueError, match="priority"):
            TenantSpec(name="t", priority="urgent")
        with pytest.raises(ValueError, match="weight"):
            TenantSpec(name="t", weight=0.0)
        with pytest.raises(ValueError, match="quota_rps"):
            TenantSpec(name="t", quota_rps=-1.0)
        with pytest.raises(ValueError, match="name"):
            TenantSpec(name="")

    def test_refit_weight_falls_back_to_weight(self):
        assert TenantSpec(name="t", weight=3.0).effective_refit_weight == 3.0
        assert TenantSpec(name="u", weight=3.0,
                          refit_weight=0.5).effective_refit_weight == 0.5


class TestWFQ:
    def test_weight_proportional_service_under_saturation(self):
        wfq = WFQScheduler({"a": 2.0, "b": 1.0})
        for i in range(30):
            wfq.enqueue("a", ("a", i))
            wfq.enqueue("b", ("b", i))
        order = [wfq.pop()[0] for _ in range(30)]
        for k in range(1, 11):
            prefix = order[: 3 * k]
            assert prefix.count("a") == 2 * k, prefix
            assert prefix.count("b") == k, prefix
        served = wfq.service_totals()
        assert served["a"] == pytest.approx(2 * served["b"])
        list(wfq.drain())
        assert len(wfq) == 0

    def test_no_starvation_under_extreme_weights(self):
        wfq = WFQScheduler({"heavy": 100.0, "light": 1.0})
        for i in range(50):
            wfq.enqueue("heavy", i)
        wfq.enqueue("light", "x")
        assert "light" in [t for t, _ in wfq.drain()]
        assert wfq.backlog() == {"heavy": 0, "light": 0}

    def test_costs_weight_the_finish_tags(self):
        wfq = WFQScheduler({"a": 1.0, "b": 1.0})
        wfq.enqueue("a", "big", cost=4.0)
        for i in range(4):
            wfq.enqueue("b", i, cost=1.0)
        assert [t for t, _ in wfq.drain()] == ["b", "b", "b", "a", "b"]
        assert wfq.service_totals() == {"a": 4.0, "b": 4.0}

    def test_unknown_tenant_is_loud(self):
        with pytest.raises(KeyError):
            WFQScheduler({"a": 1.0}).enqueue("nope", 1)


class TestAdmission:
    def test_quota_token_bucket_deterministic(self):
        ctl = AdmissionController([TenantSpec(name="t", quota_rps=2.0)])
        assert [ctl.admit("t", 1, now=t) for t in (0.0, 0.0, 0.0,
                                                   1.0, 1.0, 1.0)] == \
            [None, None, "quota", None, None, "quota"]
        assert ctl.admitted_counts() == {"t": 4}
        assert ctl.shed_counts() == {"t": {"quota": 2}}
        assert _counter("sbt_tenancy_shed_total") == 2.0
        assert _counter("sbt_tenancy_shed_total",
                        {"tenant": "t", "reason": "quota"}) == 2.0

    def test_priority_shed_ordering(self):
        ctl = AdmissionController(
            [TenantSpec(name="i", priority="interactive"),
             TenantSpec(name="s", priority="standard"),
             TenantSpec(name="b", priority="batch")],
            pressure_window_s=1.0, escalate_after=3)
        for n in ("i", "s", "b"):
            assert ctl.admit(n, 1, now=0.0) is None
        ctl.observe_overload(0.1)
        assert ctl.pressure_level(0.1) == 1
        assert [ctl.admit(n, 1, now=0.1) for n in "bsi"] == \
            ["priority", None, None]
        ctl.observe_overload(0.2)
        ctl.observe_overload(0.3)
        assert ctl.pressure_level(0.3) == 2
        assert [ctl.admit(n, 1, now=0.3) for n in "bsi"] == \
            ["priority", "priority", None]
        assert ctl.pressure_level(1.5) == 0
        assert ctl.admit("b", 1, now=1.5) is None
        assert ctl.state(now=1.5)["tenants"]["b"]["shed"] == {"priority": 2}

    def test_check_raises_typed_sheds(self):
        ctl = AdmissionController([TenantSpec(name="q", quota_rps=1.0),
                                   TenantSpec(name="b", priority="batch")])
        ctl.check("q", 1, now=0.0)
        with pytest.raises(QuotaExceeded) as ei:
            ctl.check("q", 1, now=0.0)
        assert ei.value.tenant == "q" and ei.value.reason == "quota"
        ctl.observe_overload(0.0)
        with pytest.raises(AdmissionShed) as ei:
            ctl.check("b", 1, now=0.0)
        assert ei.value.reason == "priority"

    def test_unknown_and_duplicate_tenants_loud(self):
        ctl = AdmissionController([TenantSpec(name="t")])
        with pytest.raises(KeyError):
            ctl.admit("nope", 1, now=0.0)
        with pytest.raises(ValueError, match="already"):
            ctl.add_tenant(TenantSpec(name="t"))


class TestRefitBudget:
    def test_weight_proportional_quota_with_floor(self):
        b = RefitBudgeter([TenantSpec(name="hot", weight=3.0),
                           TenantSpec(name="tail", weight=1.0)],
                          total_per_window=4, window_s=60.0)
        assert (b.quota("hot"), b.quota("tail")) == (3, 1)
        b2 = RefitBudgeter([TenantSpec(name="hog", weight=100.0),
                            TenantSpec(name="tail", weight=0.01)],
                           total_per_window=2)
        assert b2.quota("tail") == 1

    def test_window_reset_and_denial_counts(self):
        b = RefitBudgeter([TenantSpec(name="t")], total_per_window=1,
                          window_s=10.0)
        assert [b.allow("t", now=t) for t in (0.0, 1.0, 9.9, 10.0)] == \
            [True, False, False, True]
        assert b.counts() == {"allowed": {"t": 2}, "denied": {"t": 2}}
        assert _counter("sbt_tenancy_refit_denied_total",
                        {"tenant": "t"}) == 2.0

    def test_online_trainer_honors_budget_hook(self):
        from spark_bagging_tpu_torch.online import LabeledBuffer, OnlineTrainer

        X, y = _problem(n=192)
        reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=32)
        reg.register("m", _fit(), warmup=False)
        buf = LabeledBuffer()
        buf.add(X[:128], y[:128])
        budget = RefitBudgeter([TenantSpec(name="m")], total_per_window=1,
                               window_s=100.0)
        trainer = OnlineTrainer(reg, "m", buf, min_refit_rows=32,
                                margin=0.5, seed=0,
                                refit_budget=budget.for_tenant("m"))
        trainer.trigger(now=0.0)
        assert trainer.pending == 1
        trainer.trigger(now=1.0)
        assert trainer.pending == 1 and trainer.budget_denied == 1
        assert _counter("sbt_online_refits_budget_denied_total",
                        {"model": "m"}) == 1.0
        assert trainer.summary()["budget_denied"] == 1
        with pytest.raises(KeyError):
            budget.for_tenant("nope")


class _FakePlane:
    def __init__(self, owners=None, classes=None):
        self.owners = owners or {}
        self.classes = classes or {}

    def owner_label(self, fingerprint):
        return self.owners.get(fingerprint)

    def demand_class(self, owner):
        return self.classes.get(owner, "cold")


class TestCachePinPolicy:
    @staticmethod
    def _key(fp, bucket=8):
        return _pc.ProgramKey(fp, "predict", bucket, None, "t", "c", "cpu")

    class _Prog:
        nbytes = None

    def _fill(self, cache, keys):
        progs = [self._Prog() for _ in keys]
        for k, p in zip(keys, progs):
            cache.put(self._key(k), p)
        return progs  # the cache holds its programs weakly

    def test_pinned_entries_skipped(self):
        from spark_bagging_tpu_torch.tenancy.residency import cache_pin_policy

        plane = _FakePlane(owners={"a": "ta", "b": "tb", "c": "tc"},
                           classes={"ta": "hot"})
        cache = _pc.ProgramCache(capacity=2,
                                 pin_policy=cache_pin_policy(plane))
        keep = self._fill(cache, ["a", "b", "c"])
        assert [e["fingerprint"] for e in cache.snapshot()["entries"]] \
            == ["a", "c"]
        assert _counter("sbt_tenancy_pin_violations_total") == 0.0
        del keep

    def test_all_pinned_falls_back_counted(self):
        from spark_bagging_tpu_torch.tenancy.residency import cache_pin_policy

        plane = _FakePlane(owners={"a": "ta", "b": "tb", "c": "tc"},
                           classes={"ta": "hot", "tb": "hot", "tc": "hot"})
        cache = _pc.ProgramCache(capacity=2,
                                 pin_policy=cache_pin_policy(plane))
        keep = self._fill(cache, ["a", "b", "c"])
        assert [e["fingerprint"] for e in cache.snapshot()["entries"]] \
            == ["b", "c"]
        assert _counter("sbt_tenancy_pin_violations_total",
                        {"level": "cache"}) == 1.0
        del keep

    def test_policy_reads_the_armed_plane_and_skips_unowned(self):
        from spark_bagging_tpu_torch.tenancy.residency import cache_pin_policy

        pinned = cache_pin_policy()
        assert pinned("a") is False  # no plane armed
        prev = capacity_mod.install(_FakePlane(owners={"a": "ta"},
                                               classes={"ta": "hot"}))
        try:
            assert pinned("a") is True and pinned("zz") is False
        finally:
            capacity_mod.install(prev)


class TestResidency:
    def test_round_trip_bitwise_and_captures_counted(self):
        """A demoted tenant's first hit re-captures exactly its recorded
        ladder (on the CPU: rebuilds, counted in the serving counter),
        answers bitwise what a never-demoted solo executor answers, and
        its unified-cache entries leave and return with it."""
        plane = capacity_mod.CapacityPlane()
        prev = capacity_mod.install(plane)
        try:
            specs = [TenantSpec(name=f"t{i}") for i in range(2)]
            reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
            fleet = TenantFleet(specs, registry=reg, residency_capacity=1,
                                aot_root=tempfile.mkdtemp(), plane=plane)
            models = [_fit(seed=s) for s in (0, 1)]
            for i in range(2):
                fleet.register(f"t{i}", models[i], warmup=True, version=1)
            assert fleet.residency.residents() == ("t1",)
            assert reg.executor("t0").compiled_buckets == ()
            X = _problem(seed=9)[0][:8]
            # the solo executor builds into a cache of its own: the
            # fleet's restores must build, not adopt its programs
            fleet_cache = _pc.install(_pc.ProgramCache())
            solo_reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
            solo_reg.register("solo", models[0], warmup=True)
            solo = solo_reg.executor("solo").predict(X)
            _pc.install(fleet_cache)
            c0 = _counter("sbt_serving_compiles_total")
            for _ in range(3):
                assert fleet.residency.touch("t0") == "restored"
                assert reg.executor("t0").compiled_buckets == (8, 16)
                assert reg.executor("t1").compiled_buckets == ()
                assert np.array_equal(reg.executor("t0").predict(X), solo)
                assert fleet.residency.touch("t1") == "restored"
            # every restore re-captured its two-rung ladder, nothing else
            assert _counter("sbt_serving_compiles_total") - c0 == 6 * 2
            restores = [e for e in fleet.residency.events()
                        if e["kind"] == "restore"]
            assert [e["buckets"] for e in restores] == [2] * 6
            counts = fleet.residency.counts()
            assert counts["restores"] == {"t0": 3, "t1": 3}
            assert _counter("sbt_tenancy_restores_total",
                            {"tenant": "t0"}) == 3.0
            assert _counter("sbt_serving_aot_misses_total") == 0.0
            led = plane.ledger()
            assert led["reconciled"]
            assert set(led["owners"]) == {"t1"}
            events = fleet.residency.events()
            assert [e["seq"] for e in events] == \
                list(range(1, len(events) + 1))
            fleet.close()
        finally:
            capacity_mod.install(prev)

    def test_restore_reuses_the_counted_bucket_costs(self, monkeypatch):
        """A re-capture after a release reuses each bucket's counted
        cost (same weights, same shape): the counting pass runs once per
        executor and bucket, and the restored costs are the first ones."""
        from spark_bagging_tpu_torch.serving import executor as exmod

        calls = []
        real = exmod.counted_forward

        def counting(*a, **k):
            calls.append(a[-1].shape[0])
            return real(*a, **k)

        monkeypatch.setattr(exmod, "counted_forward", counting)
        reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
        ex = reg.register("m", _fit(), warmup=True)
        costs = dict(ex.bucket_costs)
        assert sorted(calls) == [8, 16]
        for _ in range(2):
            assert ex.release_programs() == (8, 16)
            assert ex.bucket_costs == {}
            assert ex.warmup((8, 16)) == (8, 16)
        assert sorted(calls) == [8, 16]
        assert ex.bucket_costs == costs

    def test_quality_tap_ladder_restored_with_the_tenant(self):
        reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
        fleet = TenantFleet([TenantSpec(name="a"), TenantSpec(name="b")],
                            registry=reg, residency_capacity=1,
                            aot_root=tempfile.mkdtemp())
        fleet.register("a", _fit(seed=0))
        reg.enable_quality("a", disagreement_every=1)
        ex = reg.executor("a")
        assert ex.replica_buckets == (8, 16)
        fleet.register("b", _fit(seed=1))  # demotes "a"
        assert ex.replica_buckets == () and ex.compiled_buckets == ()
        c0 = _counter("sbt_quality_disagreement_compiles_total")
        assert fleet.residency.touch("a") == "restored"
        assert ex.replica_buckets == (8, 16)
        assert _counter("sbt_quality_disagreement_compiles_total") - c0 == 2
        fleet.close()

    def test_hot_tenants_pinned_cold_evicted(self):
        from spark_bagging_tpu_torch.tenancy.residency import ResidencyManager

        class _Reg:
            def __init__(self):
                self.released = []

            def executor(self, name):
                reg = self

                class _Ex:
                    compiled_buckets = ()
                    replica_buckets = ()
                    quality = None
                    device = torch.device("cpu")

                    def release_programs(self):
                        reg.released.append(name)
                        return ()

                    def warmup(self, buckets=None):
                        return ()

                return _Ex()

        plane = _FakePlane(classes={"a": "hot"})
        r = ResidencyManager(_Reg(), capacity=2,
                             aot_root=tempfile.mkdtemp(), plane=plane)
        r.adopt("a")
        r.adopt("b")
        r.adopt("c")
        assert r.residents() == ("a", "c")
        assert r.counts()["pin_violations"] == {}
        plane.classes = {"a": "hot", "c": "hot"}
        r.adopt("d")
        assert r.residents() == ("c", "d")
        assert r.counts()["pin_violations"] == {"a": 1}
        assert _counter("sbt_tenancy_pin_violations_total",
                        {"tenant": "a"}) == 1.0

    def test_tenant_dir_rejects_path_separators(self):
        from spark_bagging_tpu_torch.tenancy.residency import ResidencyManager

        r = ResidencyManager(object(), capacity=1,
                             aot_root=tempfile.mkdtemp())
        with pytest.raises(ValueError, match="safe"):
            r.tenant_dir("../escape")
        with pytest.raises(ValueError, match="aot_root"):
            TenantFleet([TenantSpec(name="t")], residency_capacity=1)


class TestTenancyAlerts:
    def test_tenancy_rules_fire(self):
        rules = {r.name: r for r in alerts.default_capacity_rules(
            fast_window_s=2.0, slow_window_s=5.0, cooldown_s=0.0)}
        tail = rules["tenancy-tail-latency-burn"]
        eng = alerts.AlertEngine([tail])
        telemetry.set_gauge("sbt_tenancy_tail_p99_ms", 400.0)
        assert eng.evaluate(now=0.0) == []
        for t in (2.0, 4.0):
            eng.evaluate(now=t)
        assert [e["kind"] for e in eng.evaluate(now=5.5)] == ["alert_fired"]
        shed = rules["tenancy-quota-shed-rate"]
        assert shed.series == "sbt_tenancy_shed_total"
        eng2 = alerts.AlertEngine([shed])
        assert eng2.evaluate(now=0.0) == []
        fired = []
        for i in range(1, 12):
            telemetry.inc("sbt_tenancy_shed_total", 5.0)
            fired += [e for e in eng2.evaluate(now=float(i) / 2)
                      if e["kind"] == "alert_fired"]
        assert [e["rule"] for e in fired] == ["tenancy-quota-shed-rate"]


class TestDebugRoute:
    def test_install_seam_and_route_document(self):
        from spark_bagging_tpu.telemetry.server import (
            _debug_tenancy as jdebug,
        )
        from spark_bagging_tpu_torch.telemetry.server import _debug_tenancy

        assert _debug_tenancy() == jdebug()
        assert _debug_tenancy()["enabled"] is False
        fleet = TenantFleet([TenantSpec(name="t0"), TenantSpec(name="t1")])
        jfleet = jtenancy.TenantFleet([jtenancy.TenantSpec(name="t0"),
                                       jtenancy.TenantSpec(name="t1")])
        tenancy.install(fleet)
        jtenancy.install(jfleet)
        try:
            assert tenancy.get() is fleet
            body = _debug_tenancy()
            assert body["enabled"] is True
            assert body == jdebug()
            json.dumps(body)
        finally:
            tenancy.uninstall()
            jtenancy.uninstall()
        assert _debug_tenancy()["enabled"] is False


class TestLockOrder:
    def test_clean_over_fleet_cycle(self):
        """The lock-order detector over a full fleet cycle — admission,
        WFQ dispatch, residency demote AND restore (registry → executor
        → program cache under the residency lock) — closes no cycle."""
        from spark_bagging_tpu_torch.analysis import locks

        locks.clear()
        locks.enable(True)
        try:
            plane = capacity_mod.CapacityPlane()
            prev = capacity_mod.install(plane)
            try:
                reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
                fleet = TenantFleet(
                    [TenantSpec(name="t0", quota_rps=100.0),
                     TenantSpec(name="t1", priority="batch")],
                    registry=reg, residency_capacity=1,
                    aot_root=tempfile.mkdtemp(), plane=plane)
                for i in range(2):
                    fleet.register(f"t{i}", _fit(seed=i), version=1)
                X = _problem(seed=3)[0][:8]
                for step, name in enumerate(("t0", "t1", "t0")):
                    fleet.submit(name, X, now=float(step))
                    fleet.dispatch(now=float(step))
                fleet.refit_allowed("t0", 3.0)
                fleet.close()
            finally:
                capacity_mod.install(prev)
            assert locks.violations() == [], locks.violations()
            edges = locks.acquisition_edges()
            assert ("tenancy.residency", "serving.executor.build") in edges
            for down in ("serving.registry", "serving.executor.build",
                         "serving.program_cache"):
                assert (down, "tenancy.residency") not in edges
        finally:
            locks.enable(False)
            locks.clear()
