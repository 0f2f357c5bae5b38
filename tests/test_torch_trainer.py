"""The drift-triggered ``OnlineTrainer`` in the port against the JAX
package's, on ``examples/10_online_refit.py``'s loop at its own sizes:
512 x 8 training rows, 8 replicas of ``LogisticRegression(max_iter=5)``
with ``oob_score=True``, served on the (8, 64) ladder behind a sticky
drift monitor and a burn-rate rule, 400 stepped requests of 2 rows
with the covariate shift ``X + 4.0`` from request 200, the trainer in
stepped mode (``run_pending``) with ``LabeledBuffer(128)``, two epochs,
``margin=0.05`` and seed 0.

- Both packages write the same transcript (every record's fields but
  the wall-clock ``seconds``): the same trigger, drain, scores and
  action, the same version bump (1 -> 2) and manifest version.
- The published candidate's params are within the online tolerance
  of tests/test_torch_online.py (``W_TOL``: max |dW| within 1e-4 of
  max |W|; the refit is two warm Newton steps, the same path).
- ``publish_dir`` (the JAX checkpoint format and ``serve_config.json``)
  loads in the JAX package and serves within 1e-5 of the port, and a
  fresh port registry serves it bitwise at the published version.
- After the swap the drift gauge is back under the rule's threshold.
- A forced rejection (the trainer's ``margin`` set below -1, so no
  candidate can pass) writes one ``refit_rejected`` flight dump.
- Supervision absorbs a fault injected at each ``trainer.*`` site: the
  cycle is transcribed as an error, the live version is unchanged and
  serving goes on.
- The lock order stays clean under the port's debug locks while the
  daemon trainer refits and clients are served.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.serving import ModelRegistry as JRegistry  # noqa: E402
from spark_bagging_tpu_torch import faults, telemetry  # noqa: E402
from spark_bagging_tpu_torch.online import (  # noqa: E402
    LabeledBuffer,
    OnlineTrainer,
)
from spark_bagging_tpu_torch.serving import ModelRegistry  # noqa: E402
from spark_bagging_tpu_torch.telemetry import (  # noqa: E402
    alerts,
    recorder,
    workload,
)

D, N_TRAIN, R, STEPS, SHIFT_AT = 8, 512, 8, 400, 200
W_TOL = 1e-4
THRESHOLD = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_stream.py explains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _package(name):
    """The names example 10 imports, from either package."""
    if name == "jax":
        from spark_bagging_tpu import telemetry as tel
        from spark_bagging_tpu.online import LabeledBuffer as Buf
        from spark_bagging_tpu.online import OnlineTrainer as Trainer
        from spark_bagging_tpu.telemetry import alerts as al
        from spark_bagging_tpu.telemetry import workload as wl

        return J, tel, Buf, Trainer, JRegistry, al, wl, {}
    return (T, telemetry, LabeledBuffer, OnlineTrainer, ModelRegistry,
            alerts, workload, {"device": "cpu"})


def _concept():
    rng = np.random.default_rng(0)
    X_train = rng.normal(size=(N_TRAIN, D)).astype(np.float32)
    w_true = rng.normal(size=D)

    def labels(X):
        return (np.asarray(X, np.float64) @ w_true > 0).astype(np.int32)

    return rng, X_train, labels


def run_loop(name, publish_dir, **trainer_kw):
    """Example 10's closed loop in package ``name``; returns what the
    tests read."""
    pkg, tel, Buf, Trainer, Registry, al, wl, kw = _package(name)
    tel.reset()
    tel.enable()
    rng, X_train, labels = _concept()
    clf = pkg.BaggingClassifier(
        base_learner=pkg.LogisticRegression(max_iter=5), n_estimators=R,
        seed=0, oob_score=True, **kw).fit(X_train, labels(X_train))
    registry = Registry(min_bucket_rows=8, max_batch_rows=64)
    registry.register("prod", clf, warmup=True)
    monitor = registry.enable_quality("prod", refresh_every=1)
    engine = al.AlertEngine([al.AlertRule(
        "feature-drift", "sbt_quality_psi_max", labels=monitor.labels,
        threshold=THRESHOLD, fast_window_s=2.0, slow_window_s=8.0,
        cooldown_s=1e9)])
    buffer = Buf(capacity_rows=128, labels={"model": "prod"})
    rec = wl.WorkloadRecorder()
    rec.start()
    trainer = Trainer(registry, "prod", buffer, workload_recorder=rec,
                      epochs=2, min_refit_rows=32, margin=0.05, seed=0,
                      publish_dir=publish_dir,
                      trigger_rules=("feature-drift",), **trainer_kw)
    engine.subscribe(trainer.on_alert)
    batcher = registry.batcher("prod", threaded=False, max_delay_ms=2.0)
    fired_at = None
    try:
        for t in range(STEPS):
            Xq = rng.normal(size=(2, D)).astype(np.float32)
            if t >= SHIFT_AT:
                Xq = Xq + np.float32(4.0)
            fut = batcher.submit(Xq)
            buffer.add(Xq, labels(Xq))
            batcher.run_pending()
            fut.result(10.0)
            for ev in engine.evaluate(now=float(t) * 0.1):
                if ev["kind"] == "alert_fired" and fired_at is None:
                    fired_at = t
            trainer.run_pending(now=float(t) * 0.1)
    finally:
        batcher.close()
        rec.stop()
    # read now: the supervision drills below run more cycles on the
    # same trainer
    return dict(registry=registry, trainer=trainer, engine=engine,
                clf=clf, fired_at=fired_at, labels=labels, rng=rng,
                psi_after=registry.executor("prod").quality.drift(),
                transcript=_transcript(trainer),
                summary={k: v for k, v in trainer.summary().items()
                         if k != "transcript"},
                version=registry.version("prod"),
                W=np.array(registry.model("prod").ensemble_["W"]))


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    out = {}
    for name in ("jax", "port"):
        pub = str(tmp_path_factory.mktemp(f"publish_{name}"))
        out[name] = dict(run_loop(name, pub), publish_dir=pub)
    telemetry.reset()
    return out


def _transcript(trainer):
    return [{k: v for k, v in r.items() if k != "seconds"}
            for r in trainer.transcript]


def test_transcript_and_version_bump_equal_jax(loops):
    jax_run, port = loops["jax"], loops["port"]
    assert port["transcript"] == jax_run["transcript"]
    summ = port["summary"]
    assert summ == jax_run["summary"]
    assert (summ["triggered"], summ["published"], summ["rejected"],
            summ["skipped"], summ["errors"]) == (1, 1, 0, 0, 0)
    (record,) = port["transcript"]
    assert record["action"] == "published"
    assert record["version"] == record["manifest_version"] == 2
    assert port["version"] == jax_run["version"] == 2
    assert port["fired_at"] == jax_run["fired_at"] > SHIFT_AT


def test_candidate_params_within_online_tolerance(loops):
    W_port, W_jax = loops["port"]["W"], loops["jax"]["W"]
    assert not np.array_equal(W_port,
                              loops["port"]["clf"].ensemble_["W"].numpy())
    rel = np.abs(W_port - W_jax).max() / np.abs(W_jax).max()
    assert rel <= W_TOL, rel


def test_drift_recovers_after_the_publish_swap(loops):
    for run in loops.values():
        drift = run["psi_after"]
        assert drift["warmed"] and drift["psi_max"] < THRESHOLD
    assert loops["port"]["psi_after"]["psi_max"] == pytest.approx(
        loops["jax"]["psi_after"]["psi_max"], abs=1e-12)


def test_publish_dir_loads_in_jax_and_in_a_fresh_port_registry(loops):
    port = loops["port"]
    Xq = port["rng"].normal(size=(40, D)).astype(np.float32) + 4.0
    live = port["registry"].executor("prod").forward(Xq)
    jreg = JRegistry(min_bucket_rows=8, max_batch_rows=64)
    # the manifest's fingerprint hashes the port's class path (ROADMAP
    # Queue C, deliberate differences): the JAX registry serves the
    # weights and warns that it ignores the manifest's version
    with pytest.warns(UserWarning, match="does not match"):
        jex = jreg.load("prod", port["publish_dir"])
    np.testing.assert_allclose(np.asarray(jex.forward(Xq)), live,
                               rtol=0, atol=1e-5)
    fresh = ModelRegistry()
    ex = fresh.load("prod", port["publish_dir"], device="cpu")
    assert fresh.version("prod") == 2
    np.testing.assert_array_equal(ex.forward(Xq), live)
    assert ex.model.quality_profile_.to_dict() == \
        port["registry"].model("prod").quality_profile_.to_dict()


def test_forced_rejection_writes_one_refit_rejected_dump(tmp_path):
    run = run_loop("port", str(tmp_path / "pub"))
    reg, trainer = run["registry"], run["trainer"]
    trainer.margin = -2.0  # no score can clear incumbent + 2
    buffer = trainer.buffer
    rng, labels = run["rng"], run["labels"]
    rec = recorder.FlightRecorder(dir=str(tmp_path / "flight"),
                                  cooldown_s=3600)
    rec.arm()
    try:
        for _ in range(32):
            Xq = rng.normal(size=(2, D)).astype(np.float32) + 4.0
            buffer.add(Xq, labels(Xq))
        trainer.trigger(reason="forced")
        (record,) = trainer.run_pending()
    finally:
        rec.disarm()
    assert record["action"] == "rejected"
    assert reg.version("prod") == 2
    assert [r["kind"] for r in rec.dump_records] == ["refit_rejected"]
    assert telemetry.registry().counter(
        "sbt_online_refits_rejected_total", {"model": "prod"}).value == 1


@pytest.mark.parametrize("site", ["trainer.drain", "trainer.refit",
                                  "trainer.validate", "trainer.publish"])
def test_supervision_absorbs_a_fault_at_each_site(loops, site):
    port = loops["port"]
    reg, trainer = port["registry"], port["trainer"]
    version = reg.version("prod")
    buffer, rng, labels = trainer.buffer, port["rng"], port["labels"]
    for _ in range(32):
        Xq = rng.normal(size=(2, D)).astype(np.float32)
        buffer.add(Xq, labels(Xq))
    errors = trainer.errors
    plan = faults.FaultPlan([{"site": site, "action": "error", "at": [1]}],
                            seed=0)
    with faults.armed(plan):
        trainer.trigger(reason=f"drill {site}")
        (record,) = trainer.run_pending()
    assert record["action"] == "error" and "injected" in record["error"]
    assert trainer.errors == errors + 1
    assert reg.version("prod") == version
    assert reg.executor("prod").forward(np.zeros((3, D), np.float32)).shape \
        == (3, 2)


def test_lock_order_clean_under_debug_locks(tmp_path):
    """The daemon trainer refits while clients are served through a
    threaded batcher and the engine evaluates: the debug lock-order
    detector records no inversion."""
    import threading

    from spark_bagging_tpu_torch.analysis import locks

    locks.enable(True)
    try:
        rng, X_train, labels = _concept()
        clf = T.BaggingClassifier(T.LogisticRegression(max_iter=3),
                                  n_estimators=4, seed=0,
                                  device="cpu").fit(X_train, labels(X_train))
        reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=64)
        reg.register("m", clf, warmup=True)
        mon = reg.enable_quality("m", refresh_every=1, disagreement_every=2)
        engine = alerts.AlertEngine(alerts.default_drift_rules(
            labels=mon.labels, fast_window_s=0.01, slow_window_s=0.02))
        buffer = LabeledBuffer(capacity_rows=256)
        # margin 1: every candidate publishes (the lock order, not the
        # validation, is under test)
        trainer = OnlineTrainer(reg, "m", buffer, min_refit_rows=16,
                                margin=1.0,
                                publish_dir=str(tmp_path / "pub")).start()
        engine.subscribe(trainer.on_alert)
        stop = threading.Event()

        def client():
            r = np.random.default_rng(1)
            with reg.batcher("m", max_delay_ms=0.5) as b:
                while not stop.is_set():
                    Xq = r.normal(size=(2, D)).astype(np.float32) + 4.0
                    b.submit(Xq).result(30)
                    buffer.add(Xq, labels(Xq))

        threads = [threading.Thread(target=client) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            for i in range(40):
                engine.evaluate(now=i * 0.01)
                if trainer.summary()["published"]:
                    break
                stop.wait(0.05)
            trainer.trigger(reason="manual")
            for _ in range(200):
                if len(trainer.transcript) >= 2:
                    break
                stop.wait(0.05)
        finally:
            stop.set()
            for t in threads:
                t.join(30)
            trainer.stop()
        assert trainer.published >= 1 and trainer.errors == 0
        assert reg.version("m") >= 2
        assert os.path.isfile(tmp_path / "pub" / "serve_config.json")
        assert locks.violations() == []
    finally:
        locks.enable(False)
        locks.clear()
