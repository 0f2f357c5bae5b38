"""The port's serving plane against the JAX package's, on the CPU.

The bucket helpers are host-only copies: bitwise equal to the JAX
package's over an exhaustive small range. The port's
``EnsembleExecutor`` on ``device="cpu"`` serves weights carried across
from a JAX fit (``from_jax_arrays``) and is held against the JAX
``EnsembleExecutor`` on the same rows:

- soft-vote logistic regression and the ridge regressor within 1e-5
  (the two frameworks' float32 products round differently in the last
  bits);
- hard votes of trees, a random forest and GBTs: the vote tallies
  exactly, their fractions within one float32 ulp (the JAX package's
  XLA multiplies by the reciprocal of the replica count, the port
  divides).

A CPU bucket program is the eager forward at the bucket's shape, so the
port's own contracts are held exactly: padding never changes a real
row's output (the same slab with other padding gives the same bits),
and the micro-batcher's results are bit for bit the executor's (the
batcher tests serve a hard-vote tree bag, whose outputs do not depend
on which rows share a slab). Faults are drilled through seeded
``FaultPlan``s, which fire the same sequence in both packages.
"""

import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu import faults as jfaults  # noqa: E402
from spark_bagging_tpu.serving import buckets as jbuckets  # noqa: E402
from spark_bagging_tpu.serving import EnsembleExecutor as JExecutor  # noqa: E402
from spark_bagging_tpu_torch import faults, telemetry  # noqa: E402
from spark_bagging_tpu_torch.serving import (  # noqa: E402
    DeadlineExceeded,
    Degraded,
    EnsembleExecutor,
    MicroBatcher,
    ModelRegistry,
    Overloaded,
    buckets,
)

# soft votes and means from carried-across weights: the frameworks'
# float32 products differ in the last bits
TOL = dict(rtol=1e-5, atol=1e-6)


def _counter(name: str, labels=None) -> float:
    return telemetry.registry().counter(name, labels).value


@pytest.fixture(scope="module")
def data():
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    return make_classification(256, 8, 3, seed=11)


@pytest.fixture(scope="module")
def trees(data):
    """A hard-vote tree bag of the port: exact outputs in any batch."""
    X, y = data
    return T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=3, n_bins=16), n_estimators=8,
        max_features=0.75, voting="hard", seed=0, device="cpu").fit(X, y)


@pytest.fixture(scope="module")
def trees_b(data):
    X, y = data
    return T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=3, n_bins=16), n_estimators=8,
        max_features=0.75, voting="hard", seed=5, device="cpu").fit(X, y)


@pytest.fixture(scope="module")
def executor(trees):
    ex = EnsembleExecutor(trees, min_bucket_rows=8, max_batch_rows=64)
    ex.warmup()
    return ex


# -- bucket math: a copy, bitwise ----------------------------------------

def test_bucket_helpers_bitwise_equal_to_jax():
    for n in range(1, 4097):
        assert buckets.next_pow2(n) == jbuckets.next_pow2(n)
    for lo, hi in ((1, 1), (1, 256), (8, 4096), (3, 100), (10, 3000),
                   (64, 64)):
        assert buckets.bucket_ladder(lo, hi) == jbuckets.bucket_ladder(lo, hi)
        ladder = buckets.bucket_ladder(lo, hi)
        for n in range(1, 700):
            assert buckets.bucket_for(n, lo, hi) == \
                jbuckets.bucket_for(n, lo, hi)
            plan = buckets.pack_plan(n, lo, hi)
            assert plan == jbuckets.pack_plan(n, lo, hi)
            # every slab a rung, full top-rung slabs first, only the
            # last slab partial, and never more padding than the single
            # bucket of the residual
            assert all(b in ladder for b in plan)
            assert sum(plan[:-1]) < n <= sum(plan)
            top, k, r = ladder[-1], 0, n
            while r > top:
                k, r = k + 1, r - top
            assert plan[:k] == (top,) * k
            assert sum(plan[k:]) <= max(ladder[0], buckets.next_pow2(r))
    with pytest.raises(ValueError):
        buckets.next_pow2(0)
    with pytest.raises(ValueError):
        buckets.bucket_for(0)
    with pytest.raises(ValueError):
        buckets.pack_plan(0)
    with pytest.raises(ValueError):
        buckets.bucket_ladder(16, 8)
    X = np.arange(6, dtype=np.float32).reshape(3, 2)
    for b in (3, 4, 8):
        np.testing.assert_array_equal(buckets.pad_to_bucket(X, b),
                                      jbuckets.pad_to_bucket(X, b))
    assert buckets.pad_to_bucket(X, 3) is X


# -- the executor against the JAX executor ------------------------------

def _jax_and_port(kind, X, y):
    if kind == "logistic":
        est = J.BaggingClassifier(J.LogisticRegression(max_iter=4),
                                  n_estimators=6, max_features=0.75, seed=1)
        learner = T.LogisticRegression(max_iter=4)
    elif kind == "trees":
        est = J.BaggingClassifier(J.DecisionTreeClassifier(max_depth=3),
                                  n_estimators=6, max_features=0.75,
                                  voting="hard", seed=1)
        learner = T.DecisionTreeClassifier(max_depth=3)
    elif kind == "forest":
        est = J.RandomForestClassifier(n_estimators=6, max_depth=3,
                                       voting="hard", seed=1)
    elif kind == "gbt":
        est = J.BaggingClassifier(J.GBTClassifier(n_rounds=2, max_depth=2),
                                  n_estimators=4, voting="hard", seed=1)
        learner = T.GBTClassifier(n_rounds=2, max_depth=2)
    else:  # "ridge"
        est = J.BaggingRegressor(J.LinearRegression(l2=1e-3),
                                 n_estimators=6, max_features=0.75, seed=1)
        learner = T.LinearRegression(l2=1e-3)
    est.fit(X, y)
    arrays = {k: np.asarray(v) for k, v in est.ensemble_.items()}
    subs = np.asarray(est.subspaces_)
    if kind == "forest":
        # the forest's trees route like any depth-3 tree: its per-split
        # feature sampling only shaped the fit
        port = T.BaggingClassifier.from_jax_arrays(
            arrays, subs, classes=est.classes_, n_features=X.shape[1],
            base_learner=T.DecisionTreeClassifier(max_depth=3),
            voting="hard", device="cpu")
    elif kind == "ridge":
        port = T.BaggingRegressor.from_jax_arrays(
            arrays, subs, n_features=X.shape[1], base_learner=learner,
            device="cpu")
    else:
        port = T.BaggingClassifier.from_jax_arrays(
            arrays, subs, classes=est.classes_, n_features=X.shape[1],
            base_learner=learner, voting=est.voting, device="cpu")
    return est, port


@pytest.mark.parametrize("kind", ["logistic", "trees", "forest", "gbt",
                                  "ridge"])
def test_executor_matches_jax_executor(data, kind):
    X, y = data
    if kind == "ridge":
        y = (X[:, 0] - 0.5 * X[:, 1]).astype(np.float32)
    est, port = _jax_and_port(kind, X, y)
    jex = JExecutor(est, min_bucket_rows=16, max_batch_rows=64)
    tex = EnsembleExecutor(port, min_bucket_rows=16, max_batch_rows=64)
    rows = X[:150]  # two full 64-row slabs and a padded one
    want, got = np.asarray(jex.forward(rows)), tex.forward(rows)
    assert got.shape == want.shape and got.dtype == np.float32
    if kind in ("trees", "forest", "gbt"):
        # the vote tallies are exact; the division by the replica count
        # may round in the last bit (XLA multiplies by the reciprocal)
        R = port.n_estimators_
        np.testing.assert_array_equal(np.rint(got * R), np.rint(want * R))
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
        np.testing.assert_array_equal(tex.predict(rows), jex.predict(rows))
    else:
        np.testing.assert_allclose(got, want, **TOL)
    assert tex.compiled_buckets == jex.compiled_buckets == (32, 64)


def test_padded_rows_never_leak(trees, executor, data):
    X, _ = data
    for n in (1, 5, 8, 9, 23, 33, 64):
        got = executor.predict_proba(X[:n])
        assert got.shape == (n, 3)
        np.testing.assert_array_equal(got, trees.predict_proba(X[:n]))
    # the same real rows beside other padding: the same bits
    rng = np.random.default_rng(0)
    prog = executor.program(16)
    zeros = np.zeros((16, 8), np.float32)
    zeros[:5] = X[:5]
    junk = rng.normal(0, 1e3, (16, 8)).astype(np.float32)
    junk[:5] = X[:5]
    np.testing.assert_array_equal(prog.run(zeros, 5), prog.run(junk, 5))


def test_oversize_batches_split_into_top_bucket_slabs(trees, executor, data):
    X, _ = data
    before = _counter("sbt_serving_rows_total")
    got = executor.forward(X[:200])  # 64 + 64 + 64 + 8
    np.testing.assert_array_equal(got, trees.predict_proba(X[:200]))
    assert _counter("sbt_serving_rows_total") == before + 200
    outs = executor.forward_parts([X[:3], X[3:70], X[70:71]])
    np.testing.assert_array_equal(np.concatenate(outs), got[:71])
    assert executor.compiled_buckets == (8, 16, 32, 64)


def test_executor_validates_input_and_raises_for_unported(executor, trees):
    with pytest.raises(ValueError, match=r"\(n, 8\)"):
        executor.forward(np.zeros((2, 7), np.float32))
    with pytest.raises(ValueError, match="no rows"):
        executor.forward(np.zeros((0, 8), np.float32))
    with pytest.raises(ValueError):
        executor.forward(np.zeros((1, 2, 8), np.float32))
    # a single feature vector is one row
    assert executor.forward(np.zeros(8, np.float32)).shape == (1, 3)
    with pytest.raises(NotImplementedError, match="Queue A 12"):
        EnsembleExecutor(trees, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue A 15"):
        executor.attach_quality(object())
    with pytest.raises(ValueError, match="min_bucket_rows"):
        EnsembleExecutor(trees, min_bucket_rows=16, max_batch_rows=8)
    reg = T.BaggingRegressor(n_estimators=2, device="cpu").fit(
        np.ones((10, 8), np.float32), np.arange(10.0))
    with pytest.raises(AttributeError, match="classification-only"):
        EnsembleExecutor(reg).predict_proba(np.ones((1, 8), np.float32))


def test_zero_builds_after_warmup(trees, data):
    X, _ = data
    from spark_bagging_tpu_torch.serving import program_cache

    program_cache.clear()  # a fresh process: every rung is built here
    ex = EnsembleExecutor(trees, min_bucket_rows=4, max_batch_rows=32)
    before = _counter("sbt_serving_compiles_total")
    assert ex.warmup() == (4, 8, 16, 32)
    assert _counter("sbt_serving_compiles_total") == before + 4
    rng = np.random.default_rng(1)
    for _ in range(30):
        n = int(rng.integers(1, 150))
        assert ex.forward(X[:n]).shape == (n, 3)
    assert ex.warmup() == ()
    # a second executor of the same model adopts every rung from the
    # unified program cache: no build either
    assert EnsembleExecutor(trees, min_bucket_rows=4,
                            max_batch_rows=32).warmup() == (4, 8, 16, 32)
    assert _counter("sbt_serving_compiles_total") == before + 4


def test_program_cache_shares_live_programs_and_keeps_none_alive(data,
                                                                   tmp_path):
    # a checkpoint loaded under a second name adopts the first name's
    # programs; an adopted program holds the tensors it reads, so it
    # serves the same bits after the first model is swapped out and
    # dropped; once no executor holds a program, the cache holds nothing
    import gc

    from spark_bagging_tpu_torch.serving import program_cache

    X, y = data
    program_cache.clear()
    a = T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=3, n_bins=16), n_estimators=4,
        voting="hard", seed=7, device="cpu").fit(X, y)
    fp = EnsembleExecutor(a).fingerprint
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    ex_a = reg.register("a", a, warmup=True)
    reg.save("a", str(tmp_path / "a"))
    builds0 = _counter("sbt_serving_compiles_total")
    ex_b = reg.load("b", str(tmp_path / "a"), device="cpu")
    assert _counter("sbt_serving_compiles_total") == builds0  # adopted
    assert ex_b.program(16) is ex_a.program(16)
    want = ex_b.forward(X[:40])
    reg.swap("a", T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=2, n_bins=16), n_estimators=4,
        voting="hard", seed=8, device="cpu").fit(X, y))
    prog = ex_b.program(16)
    assert prog._params is a.ensemble_
    del a, ex_a
    gc.collect()
    np.testing.assert_array_equal(ex_b.forward(X[:40]), want)
    assert ex_b.program(16) is prog
    del prog
    reg.swap("b", trees_for_swap(X, y))
    del ex_b
    gc.collect()
    assert not [e for e in program_cache.cache().snapshot()["entries"]
                if e["fingerprint"] == fp]


def trees_for_swap(X, y):
    return T.BaggingClassifier(
        T.DecisionTreeClassifier(max_depth=2, n_bins=16), n_estimators=4,
        voting="hard", seed=9, device="cpu").fit(X, y)


# -- the micro-batcher ---------------------------------------------------

def test_micro_batch_coalesces_waiting_requests(trees, executor, data):
    X, _ = data
    ref = trees.predict_proba(X[:16])
    before = _counter("sbt_serving_batches_total")
    with MicroBatcher(executor, max_delay_ms=250, idle_flush_ms=250,
                      max_batch_rows=64, direct_dispatch=False) as b:
        futs = [b.submit(X[i:i + 1]) for i in range(16)]
        results = [f.result(30) for f in futs]
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, ref[i:i + 1])
    assert 1 <= _counter("sbt_serving_batches_total") - before <= 3
    # stepped mode: one batch of everything queued, on this thread
    b = MicroBatcher(executor, threaded=False, max_batch_rows=64)
    futs = [b.submit(X[i:i + 2], mode="predict") for i in range(0, 10, 2)]
    assert b.run_pending() == 1
    np.testing.assert_array_equal(np.concatenate([f.result(0) for f in futs]),
                                  trees.predict(X[:10]))
    assert futs[0].trace.breakdown["batch_size"] == 5
    b.close()


def test_concurrent_submitters_all_exact(trees, executor, data):
    X, _ = data
    ref = trees.predict_proba(X)
    errors = []
    with MicroBatcher(executor, max_delay_ms=2, max_batch_rows=64,
                      max_queue=256) as b:
        def client(seed):
            rng = np.random.default_rng(seed)
            for _ in range(25):
                i, n = int(rng.integers(0, 200)), int(rng.integers(1, 9))
                got = b.submit(X[i:i + n]).result(30)
                if not np.array_equal(got, ref[i:i + n]):
                    errors.append((i, n))

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)


class _Stalling:
    """An executor whose forward blocks until released: queue-full
    behavior made deterministic."""

    task, n_features, classes_ = "classification", 8, np.array([0, 1, 2])

    def __init__(self):
        self.release, self.entered = threading.Event(), threading.Event()

    def forward(self, X):
        self.entered.set()
        assert self.release.wait(30)
        return np.zeros((X.shape[0], 3), np.float32)


def test_overloaded_and_deadline_sheds_are_distinct(executor, data):
    X, _ = data
    ex = _Stalling()
    over0 = _counter("sbt_serving_shed_total", {"reason": "overload"})
    b = MicroBatcher(ex, max_delay_ms=0, max_queue=2, direct_dispatch=False)
    try:
        first = b.submit(X[:1])
        assert ex.entered.wait(10)
        b.submit(X[:1])
        b.submit(X[:1])
        with pytest.raises(Overloaded):
            b.submit(X[:1])
    finally:
        ex.release.set()
        b.close()
    assert first.result(10).shape == (1, 3)
    assert _counter("sbt_serving_shed_total",
                    {"reason": "overload"}) == over0 + 1
    # deadlines on an injected clock: expired in queue, shed as too slow
    now = [100.0]
    b = MicroBatcher(executor, threaded=False, clock=lambda: now[0])
    late = b.submit(X[:1], deadline_ms=5)
    fine = b.submit(X[1:2], deadline_ms=50)
    now[0] += 0.010
    b.run_pending()
    with pytest.raises(DeadlineExceeded):
        late.result(0)
    np.testing.assert_array_equal(fine.result(0), executor.forward(X[1:2]))
    b.close()


def test_poison_bisects_and_a_transient_is_retried(trees, executor, data):
    X, _ = data
    ref = trees.predict_proba(X[:8])
    bis0 = _counter("sbt_serving_batch_bisects_total")
    plan = faults.FaultPlan([{"site": "batcher.submit", "action": "poison",
                              "at": [3]}], seed=4)
    with faults.armed(plan):
        b = MicroBatcher(executor, threaded=False)
        futs = [b.submit(X[i:i + 1]) for i in range(8)]
        b.run_pending()
        b.close()
    for i, f in enumerate(futs):
        if i == 2:
            with pytest.raises(faults.PoisonedRequest):
                f.result(0)
        else:
            np.testing.assert_array_equal(f.result(0), ref[i:i + 1])
    # 8 -> 4 + 4 -> 2 + 2 -> 1 + 1: three bisections isolate it
    assert _counter("sbt_serving_batch_bisects_total") == bis0 + 3
    retry0 = _counter("sbt_serving_retries_total")
    plan = faults.FaultPlan([{"site": "batcher.batch_forward",
                              "action": "transient", "at": [1]}], seed=4)
    with faults.armed(plan):
        b = MicroBatcher(executor, threaded=False, retries=1,
                         retry_backoff_ms=0)
        futs = [b.submit(X[i:i + 1]) for i in range(4)]
        b.run_pending()
        b.close()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0), ref[i:i + 1])
    assert _counter("sbt_serving_retries_total") == retry0 + 1
    assert plan.snapshot()["fires"] == {"batcher.batch_forward": 1}


def test_direct_dispatch_flips_on_singletons_and_back(trees, executor, data):
    X, _ = data
    ref = trees.predict_proba(X[:40])
    d0 = _counter("sbt_serving_direct_dispatch_total")
    with MicroBatcher(executor, max_delay_ms=1, idle_flush_ms=0) as b:
        for i in range(MicroBatcher.DIRECT_AFTER_SINGLETONS + 4):
            np.testing.assert_array_equal(b.submit(X[i:i + 1]).result(30),
                                          ref[i:i + 1])
        assert b._mode_direct
        fut = b.submit(X[20:21])
        assert fut.done()  # served inline on this thread
        np.testing.assert_array_equal(fut.result(0), ref[20:21])
        assert _counter("sbt_serving_direct_dispatch_total") > d0
        # a submit that finds a request in flight proves concurrency:
        # direct mode is revoked and the request takes the coalescer
        with b._occ_lock:
            b._occupancy += 1  # a request in flight
        try:
            queued = b.submit(X[30:31])
            assert not b._mode_direct
        finally:
            with b._occ_lock:
                b._occupancy -= 1
        np.testing.assert_array_equal(queued.result(30), ref[30:31])


def test_supervised_worker_restarts_then_crash_loop_degrades(executor, data):
    X, _ = data
    r0 = _counter("sbt_serving_worker_restarts_total")
    plan = faults.FaultPlan([{"site": "batcher.worker", "action": "error",
                              "at": [1]}])
    with faults.armed(plan):
        with MicroBatcher(executor, max_delay_ms=1,
                          direct_dispatch=False) as b:
            with pytest.raises(RuntimeError, match="worker crashed"):
                b.submit(X[:1]).result(30)
            np.testing.assert_array_equal(b.submit(X[:2]).result(30),
                                          executor.forward(X[:2]))
    assert _counter("sbt_serving_worker_restarts_total") == r0 + 1
    plan = faults.FaultPlan([{"site": "batcher.worker", "action": "error",
                              "every": 1, "times": 3}])
    with faults.armed(plan):
        b = MicroBatcher(executor, max_delay_ms=1, direct_dispatch=False,
                         crash_loop_threshold=3)
        for _ in range(3):
            with pytest.raises(RuntimeError):
                b.submit(X[:1]).result(30)
        deadline = time.monotonic() + 10
        while not b.health()["degraded"] and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(Degraded):
            b.submit(X[:1])
        b.revive()
        np.testing.assert_array_equal(b.submit(X[:1]).result(30),
                                      executor.forward(X[:1]))
        b.close()
    assert not b.health()["healthy"]  # closed


def test_fault_plan_fires_the_same_sequence_in_both_packages():
    spec = {"name": "mixed", "seed": 7, "faults": [
        {"site": "batcher.batch_forward", "action": "transient",
         "every": 3, "times": 4},
        {"site": "batcher.submit", "action": "poison", "p": 0.3},
        {"site": "executor.forward_piece", "action": "error", "at": [2, 5],
         "tenant": "t1"},
    ]}

    def drive(mod):
        plan = mod.FaultPlan.from_dict(spec)
        seq = []
        for i in range(40):
            for site, info in (("batcher.submit", {}),
                               ("batcher.batch_forward", {}),
                               ("executor.forward_piece",
                                {"tenant": "t1" if i % 2 else "t2"})):
                try:
                    seq.append(plan.fire(site, **info))
                except Exception as e:  # noqa: BLE001 - the sequence
                    seq.append(type(e).__name__)
        return seq, plan.snapshot(), plan.digest()

    assert drive(faults) == drive(jfaults)
    assert faults.SITES == jfaults.SITES


# -- the registry --------------------------------------------------------

def test_registry_versions_and_swap_contract_rejections(trees, trees_b,
                                                        data):
    X, y = data
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=32)
    ex = reg.register("m", trees, warmup=True)
    assert reg.names() == ("m",) and reg.version("m") == 1
    assert ex.model_name == "m" and reg.model("m") is trees
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", trees)
    rej0 = _counter("sbt_serving_swap_rejected_total")
    wide = T.BaggingClassifier(n_estimators=2, device="cpu").fit(
        np.hstack([X, X[:, :1]]), y)
    two = T.BaggingClassifier(n_estimators=2, device="cpu").fit(X, y % 2)
    regr = T.BaggingRegressor(n_estimators=2, device="cpu").fit(
        X, X[:, 0])
    for bad, match in ((wide, "feature width"), (two, "class set"),
                       (regr, "task")):
        with pytest.raises(ValueError, match=match):
            reg.swap("m", bad)
    assert _counter("sbt_serving_swap_rejected_total") == rej0 + 3
    assert reg.version("m") == 1 and reg.executor("m") is ex
    new = reg.swap("m", trees_b)
    assert reg.version("m") == 2 and new.model_version == 2
    # the pre-capture covered the live rungs before the switch
    assert new.compiled_buckets == ex.compiled_buckets
    with pytest.raises(ValueError, match="stale swap"):
        reg.swap("m", trees, version=2)
    with pytest.raises(KeyError):
        reg.executor("nope")
    with pytest.raises(NotImplementedError, match="Queue A 15"):
        reg.enable_quality("m")
    assert reg.health() == {"healthy": True, "models": {"m": 2}}


def test_failed_pre_capture_rolls_the_swap_back(trees, trees_b):
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=32)
    ex = reg.register("m", trees, warmup=True)
    plan = faults.FaultPlan([{"site": "registry.swap.precompile",
                              "action": "error", "at": [2]}])
    with faults.armed(plan), pytest.raises(RuntimeError,
                                           match="rolled") as info:
        reg.swap("m", trees_b)
    assert reg.executor("m") is ex and reg.version("m") == 1
    # the replacement's pre-captures were released, not left in the
    # program cache for nothing to serve — even while the caller keeps
    # the error, whose traceback holds the replacement executor
    assert info.value is not None
    import gc

    from spark_bagging_tpu_torch.serving import program_cache

    gc.collect()
    fp_b = EnsembleExecutor(trees_b).fingerprint
    assert not [e for e in program_cache.cache().snapshot()["entries"]
                if e["fingerprint"] == fp_b]


def test_hot_swap_mid_traffic_drops_nothing(trees, trees_b, data):
    X, _ = data
    ref_a, ref_b = trees.predict_proba(X), trees_b.predict_proba(X)
    assert not np.array_equal(ref_a, ref_b)
    from spark_bagging_tpu_torch.serving import program_cache

    program_cache.clear()  # a fresh process
    reg = ModelRegistry(min_bucket_rows=1, max_batch_rows=64)
    reg.register("m", trees, warmup=True)
    builds0 = _counter("sbt_serving_compiles_total")
    stop, errors, checked = threading.Event(), [], [0]

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            i = int(rng.integers(0, len(X)))
            try:
                r = b.submit(X[i:i + 1]).result(30)
            except Exception as e:  # noqa: BLE001 - collected
                errors.append(e)
                return
            if not (np.array_equal(r, ref_a[i:i + 1])
                    or np.array_equal(r, ref_b[i:i + 1])):
                errors.append(AssertionError(f"row {i}: mixed result"))
                return
            checked[0] += 1

    with reg.batcher("m", max_delay_ms=1) as b:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for k in range(4):
            time.sleep(0.03)
            reg.swap("m", (trees_b, trees)[k % 2])
        time.sleep(0.03)
        stop.set()
        for t in threads:
            t.join(60)
    assert not errors, errors[:3]
    assert checked[0] > 20 and reg.version("m") == 5
    # every build was a swap's pre-capture of the 7 live rungs (a
    # retired model's programs leave the cache, so swapping back
    # captures again): the request path never built a program
    assert _counter("sbt_serving_compiles_total") - builds0 == 4 * 7


def test_registry_save_load_serve_config(trees, trees_b, data, tmp_path):
    X, _ = data
    reg = ModelRegistry(min_bucket_rows=4, max_batch_rows=32)
    reg.register("m", trees, warmup=True)
    reg.swap("m", trees_b)
    path = str(tmp_path / "ckpt")
    reg.save("m", path)
    cfg = json.load(open(os.path.join(path, "serve_config.json")))
    assert cfg["version"] == 2 and cfg["executor"]["min_bucket_rows"] == 4
    assert not os.path.exists(os.path.join(path, "serving_aot"))
    # a fresh process adopts the version and the executor configuration
    peer = ModelRegistry()
    ex = peer.load("m", path, device="cpu")
    assert peer.version("m") == 2 and ex.max_batch_rows == 32
    np.testing.assert_array_equal(ex.forward(X[:40]),
                                  reg.executor("m").forward(X[:40]))
    assert peer.load("m", path, device="cpu") is ex  # idempotent re-load
    # a newer live version rejects an older manifest
    peer.swap("m", trees)
    assert peer.version("m") == 3
    with pytest.raises(ValueError, match="stale swap"):
        peer.load("m", path, device="cpu")
    # a JAX peer's persisted executables are counted and ignored
    os.makedirs(os.path.join(path, "serving_aot"))
    miss0 = _counter("sbt_serving_aot_misses_total")
    ModelRegistry().load("m", path, device="cpu")
    assert _counter("sbt_serving_aot_misses_total") == miss0 + 1


@pytest.mark.parametrize("site", ["checkpoint.write",
                                  "registry.save.checkpoint",
                                  "registry.save.aot",
                                  "registry.save.manifest"])
def test_torn_save_always_leaves_a_loadable_checkpoint(trees, trees_b, data,
                                                       tmp_path, site):
    X, _ = data
    path = str(tmp_path / "ckpt")
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    reg.register("m", trees, warmup=True)
    reg.save("m", path)  # v1 committed
    reg.swap("m", trees_b)
    plan = faults.FaultPlan([{"site": site, "action": "kill", "at": [1]}])
    with faults.armed(plan), pytest.raises(faults.SimulatedKill):
        reg.save("m", path)
    peer = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    ex = peer.load("m", path, device="cpu")
    # a kill before the checkpoint's own swap leaves v1 whole; any later
    # kill leaves v2's complete weights (the manifest not yet written)
    want = trees if site == "checkpoint.write" else trees_b
    assert ex.fingerprint == EnsembleExecutor(want).fingerprint
    np.testing.assert_array_equal(ex.forward(X[:20]),
                                  want.predict_proba(X[:20]))


def test_stale_serve_config_is_detected_by_fingerprint(trees, trees_b,
                                                       tmp_path):
    import shutil

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    reg.register("m", trees, warmup=True)
    reg.save("m", b)
    reg.swap("m", trees_b)
    reg.save("m", a)  # v2's manifest, beside v2's weights
    # the torn state by hand: v1's weights under v2's manifest, whose
    # executor section is poisoned too
    shutil.copy(os.path.join(a, "serve_config.json"),
                os.path.join(b, "serve_config.json"))
    cfg_path = os.path.join(b, "serve_config.json")
    cfg = json.load(open(cfg_path))
    cfg["executor"]["max_batch_rows"] = 999
    json.dump(cfg, open(cfg_path, "w"))
    peer = ModelRegistry(min_bucket_rows=8, max_batch_rows=16)
    with pytest.warns(UserWarning, match="does not match"):
        ex = peer.load("m", b, device="cpu")
    # neither the stale version nor its executor config is adopted
    assert peer.version("m") == 1 and ex.max_batch_rows == 16
    assert ex.fingerprint == EnsembleExecutor(trees).fingerprint
