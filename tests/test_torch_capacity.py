"""The capacity plane and the executor's bucket costs in the port, held
against the JAX package's where both run:

- ``classify_rate`` gives the same class sequence on the same seeded
  rate streams, with and without hysteresis;
- ``capacity_report()`` after the same register, swap and failed-swap
  sequence over CPU models of both packages has the same shape: the
  same top-level, cache, owner, committed, resident and demand keys,
  and the same committed ``model@version`` names with the same
  liveness;
- the logistic bag's bucket FLOPs are the analytic count of its
  forward's products, ``2·b·R·(d_sub+1)·C`` (the bias column), and its
  bytes every input read once plus the output written once; a tree
  bag's forward runs no counted product, so its ``flops`` is None;

and the JAX package's contracts, copied: the ledger reconciles exactly
with the cache's own totals (an anonymous executor's entries roll up
unattributed; an entry whose executor was collected leaves both), the
unarmed demand tap is one attribute read, a failed swap leaks nothing,
evictions and fingerprint drops charge their owner, and a second
executor of the same weights leaves its programs charged to the first
owner. On the CPU a bucket program holds no device memory of its own:
every entry is ``unmeasured``, never counted as 0 bytes.
"""

import gc
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from spark_bagging_tpu import BaggingClassifier as JBaggingClassifier  # noqa: E402
from spark_bagging_tpu import LogisticRegression as JLogistic  # noqa: E402
from spark_bagging_tpu import faults as jfaults  # noqa: E402
from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.serving import ModelRegistry as JRegistry  # noqa: E402
from spark_bagging_tpu.serving import program_cache as jpc  # noqa: E402
from spark_bagging_tpu.telemetry import capacity as jcapacity  # noqa: E402
from spark_bagging_tpu_torch import (  # noqa: E402
    BaggingClassifier,
    DecisionTreeClassifier,
    LogisticRegression,
    faults,
    telemetry,
)
from spark_bagging_tpu_torch.serving import (  # noqa: E402
    EnsembleExecutor,
    ModelRegistry,
)
from spark_bagging_tpu_torch.serving import program_cache as _pc  # noqa: E402
from spark_bagging_tpu_torch.telemetry import capacity  # noqa: E402
from spark_bagging_tpu_torch.utils.memory import device_memory_stats  # noqa: E402

WIDTH = 6


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    capacity.disable()
    jcapacity.disable()
    prev = _pc.install(_pc.ProgramCache(capacity=64))
    jprev = jpc.install(jpc.ProgramCache(capacity=64))
    yield
    _pc.install(prev)
    jpc.install(jprev)
    capacity.disable()
    jcapacity.disable()
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


def _data(seed=0, n=64):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, WIDTH)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    return X, y


def _fitted(seed=0, n_estimators=2, cls=BaggingClassifier, **kw):
    X, y = _data(seed)
    learner = (LogisticRegression if cls is BaggingClassifier
               else JLogistic)(max_iter=3)
    extra = {"device": "cpu"} if cls is BaggingClassifier else {}
    return cls(learner, n_estimators=n_estimators, seed=seed, **extra,
               **kw).fit(X, y)


@pytest.fixture(scope="module")
def clf():
    return _fitted(seed=0)


@pytest.fixture(scope="module")
def clf_b():
    return _fitted(seed=7)


def _registry(model, name="a", reg_cls=ModelRegistry):
    reg = reg_cls(min_bucket_rows=8, max_batch_rows=16)
    reg.register(name, model, warmup=False, version=1)
    return reg


def _rows(n=4, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, WIDTH)).astype(np.float32)


# -- parity with the JAX package ----------------------------------------

@pytest.mark.parametrize("hysteresis", [0.5, 1.0])
def test_classify_rate_equals_jax_on_seeded_streams(hysteresis):
    rng = np.random.default_rng(11)
    rates = rng.lognormal(mean=1.0, sigma=2.0, size=400).tolist()
    ours, theirs = [], []
    prev_o = prev_j = None
    for r in rates:
        prev_o = capacity.classify_rate(prev_o, r, hot_rps=50.0,
                                        warm_rps=1.0,
                                        hysteresis=hysteresis)
        prev_j = jcapacity.classify_rate(prev_j, r, hot_rps=50.0,
                                         warm_rps=1.0,
                                         hysteresis=hysteresis)
        ours.append(prev_o)
        theirs.append(prev_j)
    assert ours == theirs
    assert set(ours) == {"hot", "warm", "cold"}


def _report_shape(rep: dict) -> dict:
    """The key structure of a capacity report, owner names aside."""
    def keys_of(d):
        return sorted(d) if isinstance(d, dict) else d

    return {
        "top": sorted(rep),
        "cache": keys_of(rep["cache"]),
        "owner_keys": sorted({k for o in rep["owners"].values()
                              for k in o}),
        "committed": {name: (sorted(c), c["live"])
                      for name, c in rep["committed"].items()},
        "resident_keys": sorted({k for r in rep["residents"] for k in r}),
        "demand": {m: sorted(d) for m, d in rep["demand"].items()},
        "thresholds": keys_of(rep["thresholds"]),
    }


def _sequence(reg_cls, cap_mod, faults_mod, a, b, c):
    """register a, serve, swap to b, serve, a swap to c that fails in
    pre-compile; return the report."""
    cap_mod.enable()
    reg = _registry(a, reg_cls=reg_cls)
    reg.executor("a").forward(_rows())
    reg.swap("a", b)
    reg.executor("a").forward(_rows(seed=2))
    plan = faults_mod.FaultPlan([{
        "site": "registry.swap.precompile", "action": "error",
        "at": [1],
    }])
    with faults_mod.armed(plan):
        with pytest.raises(Exception):
            reg.swap("a", c)
    rep = cap_mod.capacity_report()
    assert rep["reconciled"] is True
    return rep


def test_capacity_report_keys_equal_jax_after_register_swap_failed_swap():
    ours = _sequence(ModelRegistry, capacity, faults, _fitted(0),
                     _fitted(7), _fitted(9))
    theirs = _sequence(JRegistry, jcapacity, jfaults,
                       _fitted(0, cls=JBaggingClassifier),
                       _fitted(7, cls=JBaggingClassifier),
                       _fitted(9, cls=JBaggingClassifier))
    assert _report_shape(ours) == _report_shape(theirs)
    assert sorted(ours["committed"]) == ["a@1", "a@2"]
    # the port's swap drops the retired fingerprint's programs from the
    # cache (charged as evictions; the JAX package keeps them until LRU
    # pressure), so only the port's report lists evictions here: their
    # records carry the JAX plane's keys
    kw = dict(fingerprint="f", bucket=8, variant="v", nbytes=None, seq=1)
    for plane in (capacity.ACTIVE, jcapacity.ACTIVE):
        plane.observe_eviction(**kw)
    assert capacity.ACTIVE.recent_evictions()[-1] == \
        jcapacity.ACTIVE.recent_evictions()[-1]
    # the failed swap's replacement never became an owner in either
    assert ours["demand"]["a"]["requests"] == \
        theirs["demand"]["a"]["requests"] == 2


def test_logistic_bucket_flops_are_the_analytic_product_count():
    """2·b·R·(d_sub+1)·C: each replica's (b, d_sub+1) @ (d_sub+1, C)
    forward product, the bias column included (models/logistic.py)."""
    X, y = _data(3, n=90)
    y = np.digitize(X[:, 1], [-0.5, 0.5]).astype(np.int64)  # 3 classes
    R, C = 4, 3
    bag = BaggingClassifier(LogisticRegression(max_iter=2),
                            n_estimators=R, max_features=0.5, seed=3,
                            device="cpu").fit(X, y)
    d_sub = bag.subspaces_.shape[1]
    assert d_sub == 3
    ex = EnsembleExecutor(bag, min_bucket_rows=1, max_batch_rows=32)
    ex.warmup()
    fn, params, subs = bag.aggregated_forward()
    in_bytes = sum(int(t.nbytes) for _p, t in _pc._leaves((params, subs)))
    for b, cost in ex.bucket_costs.items():
        assert cost["flops"] == 2 * b * R * (d_sub + 1) * C, b
        assert cost["bytes"] == in_bytes + b * WIDTH * 4 + b * C * 4
    assert sorted(ex.bucket_costs) == list(ex.compiled_buckets)
    reg = telemetry.registry()
    assert reg.peek("sbt_serving_bucket_cost_flops",
                    {"bucket": "32"}).value == 2 * 32 * R * (d_sub + 1) * C
    # a served slab counts its FLOPs and padding's row share of them
    ex8 = EnsembleExecutor(bag, min_bucket_rows=8, max_batch_rows=32)
    ex8.forward(X[:5])  # bucket 8: 3 padding rows
    f8 = ex8.bucket_costs[8]["flops"]
    assert reg.counter("sbt_serving_flops_total").value == f8
    assert reg.counter("sbt_serving_padding_flops_total").value \
        == pytest.approx(3 / 8 * f8)
    assert ex.release_programs() and ex.bucket_costs == {}


def test_tree_forward_counts_no_flops_and_bytes_still():
    X, y = _data(4)
    trees = BaggingClassifier(DecisionTreeClassifier(max_depth=3,
                                                     n_bins=8),
                              n_estimators=3, voting="hard", seed=4,
                              device="cpu").fit(X, y)
    ex = EnsembleExecutor(trees, min_bucket_rows=4, max_batch_rows=8)
    ex.warmup()
    for cost in ex.bucket_costs.values():
        assert cost["flops"] is None and cost["bytes"] > 0
    ex.forward(X[:3])
    assert telemetry.registry().peek("sbt_serving_flops_total") is None
    assert telemetry.registry().peek("sbt_serving_bucket_cost_flops",
                                     {"bucket": "4"}) is None


# -- the JAX package's contracts ------------------------------------------

def test_executable_bytes_ladder_is_honest():
    class Graphish:
        nbytes = 4096

    assert capacity.executable_bytes(Graphish()) == (4096, "graph_pool")
    assert capacity.executable_bytes(object()) == (None, "unmeasured")
    ex = EnsembleExecutor(_fitted(0), min_bucket_rows=8, max_batch_rows=8)
    ex.warmup()
    assert capacity.executable_bytes(ex.program(8)) == (None, "unmeasured")


def test_ledger_reconciles_exactly_against_cache_totals(clf, clf_b):
    plane = capacity.enable()
    reg = _registry(clf, "a")
    reg.register("b", clf_b, warmup=False, version=1)
    reg.executor("a").forward(_rows())
    reg.executor("b").forward(_rows(seed=2))
    anon = EnsembleExecutor(_fitted(seed=42), min_bucket_rows=4,
                            max_batch_rows=8)
    anon.forward(_rows(n=3, seed=3))
    led = plane.ledger()
    assert led["reconciled"] is True
    stats = _pc.cache().stats()
    assert sum(o["entries"] for o in led["owners"].values()) \
        == stats["entries"] == 3
    assert sum(o["unmeasured"] for o in led["owners"].values()) \
        == stats["unmeasured"] == 3
    assert sum(o["bytes"] for o in led["owners"].values()) \
        == stats["bytes"] == 0
    assert sorted(led["owners"]) == ["(unattributed)", "a", "b"]
    rec = led["committed"]["a@1"]
    assert rec["params_bytes"] == capacity.params_nbytes(reg.executor("a"))
    assert rec["placement"] == "cpu" and rec["live"] is True
    # the cache holds its programs weakly: a collected executor's
    # entries leave the cache's totals and the ledger together
    del anon
    gc.collect()
    led = plane.ledger()
    assert led["reconciled"] is True
    assert capacity.UNATTRIBUTED not in led["owners"]
    assert led["cache"]["entries"] == 2


def test_params_bytes_are_the_parameter_and_subspace_tensors(clf):
    plane = capacity.enable()
    reg = _registry(clf, "a")
    ex = reg.executor("a")
    want = sum(int(t.nbytes) for _p, t in
               _pc._leaves((clf.ensemble_, clf.subspaces_)))
    assert capacity.params_nbytes(ex) == want > 0
    assert plane.ledger()["committed"]["a@1"]["params_bytes"] == want
    assert telemetry.registry().peek(
        "sbt_capacity_params_bytes", {"model": "a", "version": "1"}
    ).value == float(want)


def test_forward_feeds_demand_and_anonymous_stay_out(clf):
    plane = capacity.enable()
    reg = _registry(clf, "a")
    reg.executor("a").forward(_rows(n=4))
    reg.executor("a").forward_parts([_rows(n=1), _rows(n=2, seed=3)])
    EnsembleExecutor(clf, min_bucket_rows=4,
                     max_batch_rows=8).forward(_rows(n=2))
    s = plane.demand_summary()
    assert s == {"a": {"requests": 3, "rows": 7, "rank": 1,
                       "class": "cold"}}
    assert telemetry.registry().peek(
        "sbt_capacity_demand_rows_total", {"model": "a"}).value == 7.0


def test_unarmed_demand_probe_is_one_attribute_read(clf, monkeypatch):
    capacity.disable()

    def boom(*a, **kw):  # pragma: no cover — must never run
        raise AssertionError("unarmed forward touched the plane")

    monkeypatch.setattr(capacity.CapacityPlane, "observe_demand", boom)
    _registry(clf, "a").executor("a").forward(_rows())
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        cap = capacity.ACTIVE
        if cap is not None:  # pragma: no cover — disabled
            raise AssertionError
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 2e-6, f"{per_call * 1e9:.0f}ns per probe"


def test_failed_swap_leaks_no_ledger_entries(clf, clf_b):
    plane = capacity.enable()
    reg = _registry(clf, "a")
    reg.executor("a").forward(_rows())
    plan = faults.FaultPlan([{"site": "registry.swap.precompile",
                              "action": "error", "at": [1]}])
    with faults.armed(plan):
        with pytest.raises(Exception):
            reg.swap("a", clf_b)
    led = plane.ledger()
    assert sorted(led["committed"]) == ["a@1"]
    assert led["reconciled"] is True
    assert sorted(led["owners"]) == ["a"]


def test_committed_swap_retires_the_old_version_and_charges_its_drop(
        clf, clf_b):
    plane = capacity.enable()
    reg = _registry(clf, "a")
    reg.executor("a").forward(_rows())
    reg.swap("a", clf_b)
    led = plane.ledger()
    assert led["committed"]["a@1"]["live"] is False
    assert led["committed"]["a@2"]["live"] is True
    assert led["reconciled"] is True
    # the retired fingerprint's programs left the cache, charged to it
    assert plane.eviction_counts() == {"a": 1}
    fps = {e["fingerprint"] for e in _pc.cache().snapshot()["entries"]}
    assert fps == {reg.executor("a").fingerprint}


def test_evictions_charge_the_owner_and_keep_unlabeled_totals(clf, clf_b):
    plane = capacity.enable()
    _pc.install(_pc.ProgramCache(capacity=1))
    reg = _registry(clf, "a")
    reg.register("b", clf_b, warmup=False, version=1)
    reg.executor("a").forward(_rows())
    reg.executor("b").forward(_rows(seed=2))  # evicts a's
    assert plane.eviction_counts() == {"a": 1}
    (ev,) = plane.recent_evictions()
    assert ev["owner"] == "a" and ev["bytes"] is None
    t = telemetry.registry()
    assert t.peek("sbt_program_cache_evictions_total",
                  {"model": "a"}).value == 1.0
    assert t.counter("sbt_program_cache_evictions_total").value == 1.0
    assert t.peek("sbt_program_cache_misses_total",
                  {"model": "b"}).value == 1.0


def test_pin_policy_skips_pinned_entries():
    a, b = _fitted(0), _fitted(7)
    ea = EnsembleExecutor(a, min_bucket_rows=8, max_batch_rows=8)
    eb = EnsembleExecutor(b, min_bucket_rows=8, max_batch_rows=8)
    cache = _pc.ProgramCache(capacity=1,
                             pin_policy=lambda fp: fp == ea.fingerprint)
    _pc.install(cache)
    ea.warmup()
    eb.warmup()  # a is pinned, but alone it overflows: a violation
    assert telemetry.registry().counter(
        "sbt_tenancy_pin_violations_total").value == 1.0
    assert len(cache) == 1


def test_adopted_programs_stay_charged_to_the_first_owner(clf):
    """A second registry name over the same weights adopts the first
    one's programs (one cache entry a bucket): they stay charged to
    the first owner, whose pool holds their bytes."""
    plane = capacity.enable()
    reg = _registry(clf, "first")
    reg.executor("first").forward(_rows())
    reg.register("second", clf, warmup=False, version=1)
    reg.executor("second").forward(_rows(seed=5))
    assert reg.executor("second").program(8) is \
        reg.executor("first").program(8)
    led = plane.ledger()
    assert sorted(led["owners"]) == ["first"]
    assert led["owners"]["first"]["entries"] == 1
    assert sorted(led["committed"]) == ["first@1", "second@1"]


def test_report_surfaces_and_disabled_stub(clf):
    rep = capacity.capacity_report()
    assert rep["enabled"] is False and "entries" in rep["cache"]
    capacity.enable()
    reg = _registry(clf, "a")
    reg.executor("a").forward(_rows())
    rep = capacity.capacity_report()
    (res,) = rep["residents"]
    assert res["owner"] == "a" and res["unmeasured"] is True
    assert res["bytes_source"] == "unmeasured"
    assert rep["device_memory"] is None  # the CPU reports none
    assert telemetry.registry().peek(
        "sbt_capacity_cache_headroom_ratio").value == 63 / 64


def test_device_memory_stats_is_none_without_cuda():
    assert device_memory_stats() is None
