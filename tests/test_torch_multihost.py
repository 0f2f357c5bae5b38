"""The port on more than one process: 2 OS processes x 2 CPU mesh
positions each, joined by ``initialize_distributed`` over gloo on a
loopback port, fitting on ONE ``(data=2, replica=2)`` mesh that spans
both (process 0 on data row 0, process 1 on row 1).

The port's counterpart of tests/test_multihost.py, each check made
stricter where the port allows: the psums of a process-spanning mesh
gather every member's value and sum them in shard order in every
process, so

- both processes hold bitwise the same fitted state;
- the 2-process fits are bitwise the port's 1-process ``(2, 2)`` CPU
  mesh fits in this process (logistic with OOB, the SGD stream and its
  resume from a mid-fit snapshot, the forest, AFT with the aux channel,
  the pooled warm start, the Arrow stream);
- that 1-process mesh is within the sharded tests' tolerance of the
  JAX package's single-process ``(2, 2)`` mesh on the same inputs
  (JAX's own 2-process workers are tests/test_multihost.py's).

Also: only process 0 writes snapshots and checkpoints; ``oob_score``
with ``fit_stream`` on such a mesh raises JAX's message;
``initialize_distributed``'s argument errors are JAX's;
``sbt_h2d_bytes_total{process}`` counts each process's own shards; a
worker that raises fails both workers within the test's limit.

The workers are this file run as a script (its ``__main__`` block);
they log to files, never to pipes (an undrained pipe could stall one
inside a collective), and are killed at a hard limit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

#: seconds a worker's collective waits for its peer before failing
GROUP_TIMEOUT_S = 30.0
#: seconds after which the test kills the workers
HARD_LIMIT_S = 120.0
PROBA_ATOL = 1e-5  # tests/test_torch_sharded.py's
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _data():
    """JAX's worker inputs: breast cancer, standardized."""
    from sklearn.datasets import load_breast_cancer
    from sklearn.preprocessing import StandardScaler

    X, y = load_breast_cancer(return_X_y=True)
    return StandardScaler().fit_transform(X).astype(np.float32), y


def _survival(X, y):
    """JAX's worker's censored survival times and censor flags."""
    rng = np.random.default_rng(0)
    times = np.exp(X[:, 0] * 0.5 + 0.3 * np.log(rng.exponential(1.0, len(y)))
                   ).astype(np.float32)
    cutoff = np.quantile(times, 0.7)
    return (np.minimum(times, cutoff),
            (times <= cutoff).astype(np.float32))


def _fit_all(mod, mesh, X, y, workdir: str, scratch: str
             ) -> tuple[dict, dict]:
    """Every fit of JAX's multihost worker on ``mesh`` (``mod`` is the
    port) over ``(X, y)``, plus the stream's resume from its mid-fit
    snapshot and a ``save``. ``workdir`` is shared by the processes
    (snapshot and checkpoint), ``scratch`` is this process's. Returns
    ``(arrays, scalars)``."""
    from spark_bagging_tpu_torch import telemetry

    arrays, scalars = {}, {}

    def keep(name, est, Xq=X):
        for k, v in est.ensemble_.items():
            arrays[f"{name}.{k}"] = v.cpu().numpy()
        arrays[f"{name}.subspaces"] = est.subspaces_.cpu().numpy()
        pred = (est.predict_proba(Xq) if hasattr(est, "predict_proba")
                else est.predict(Xq))
        arrays[f"{name}.pred"] = pred
        scalars[f"{name}.score"] = (float(est.score(X, y))
                                    if name != "aft" else None)

    clf = mod.BaggingClassifier(n_estimators=8, seed=1, mesh=mesh,
                                max_features=0.8, oob_score=True).fit(X, y)
    scalars["series_after_logistic"] = [
        [s["name"], s["labels"], s.get("value", s.get("count"))]
        for s in telemetry.registry().snapshot()
        if s["name"] in ("sbt_h2d_bytes_total", "sbt_d2h_bytes_total",
                         "sbt_collective_seconds")]
    keep("logistic", clf)
    arrays["logistic.oob"] = clf.oob_decision_function_
    scalars["logistic.oob_score"] = float(clf.oob_score_)
    clf.save(os.path.join(workdir, "model"))

    ck = os.path.join(workdir, "stream_ck")
    src = mod.ArrayChunks(X, y, chunk_rows=128)
    stream = mod.BaggingClassifier(n_estimators=8, seed=1, mesh=mesh)
    stream.fit_stream(src, n_epochs=8, lr=0.05, checkpoint_dir=ck,
                      checkpoint_every=12)
    keep("stream", stream)
    resumed = mod.BaggingClassifier(n_estimators=8, seed=1, mesh=mesh)
    resumed.fit_stream(src, n_epochs=8, lr=0.05, resume_from=ck)
    keep("stream_resumed", resumed)
    with open(os.path.join(ck, "meta.json")) as f:
        scalars["snapshot_steps"] = json.load(f)["steps_done"]

    rf = mod.RandomForestClassifier(n_estimators=4, max_depth=3, seed=1,
                                    mesh=mesh).fit(X, y)
    keep("forest", rf)
    t, censored = _survival(X, y)
    aft = mod.BaggingRegressor(
        base_learner=mod.AFTSurvivalRegression(max_iter=40),
        n_estimators=4, seed=1, mesh=mesh).fit(X, t, aux=censored)
    keep("aft", aft, X[:16])
    pooled = mod.BaggingClassifier(
        base_learner=mod.LogisticRegression(
            l2=1e-3, max_iter=1, init="pooled", precision="high"),
        n_estimators=8, seed=1, mesh=mesh).fit(X, y)
    keep("pooled", pooled)

    from spark_bagging_tpu_torch.utils.arrow import (
        ArrowChunks,
        write_row_major_ipc,
    )

    path = os.path.join(scratch, "rows.arrow")
    write_row_major_ipc(path, X, y, chunk_rows=128, label_dtype=np.int32)
    arrow = mod.BaggingClassifier(n_estimators=8, seed=1, mesh=mesh)
    arrow.fit_stream(ArrowChunks(path, 128), classes=[0, 1], n_epochs=4,
                     lr=0.05)
    keep("arrow", arrow)

    try:
        mod.BaggingClassifier(n_estimators=8, seed=1, mesh=mesh,
                              oob_score=True).fit_stream(src)
        scalars["oob_stream_error"] = None
    except ValueError as e:
        scalars["oob_stream_error"] = str(e)
    scalars["checkpoint_bytes_saved"] = sum(
        s["value"] for s in telemetry.registry().snapshot()
        if s["name"] == "sbt_checkpoint_bytes_total"
        and s["labels"].get("op") == "save")
    return arrays, scalars


def _worker(pid: int, port: int, out: str, mode: str) -> None:
    """One process of the 2-process run (``mode`` "fit" or "raise"); the
    data is the test process's ``_data()``, in ``out/data.npz`` (which
    the test writes while the workers start)."""
    import torch

    import spark_bagging_tpu_torch as T
    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    torch.set_num_threads(1)
    timeout = GROUP_TIMEOUT_S if mode == "fit" else 10.0
    n_dev = initialize_distributed(f"127.0.0.1:{port}", 2, pid,
                                   timeout_s=timeout)
    mesh = make_mesh(data=2, replica=2, devices=["cpu"] * 2)
    if mode == "raise":
        from spark_bagging_tpu_torch.parallel.compat import (
            P,
            axis_index,
            psum,
            shard_map,
        )

        def body(x):
            if axis_index("data") == 0 and axis_index("replica") == 0:
                raise ValueError("shard (0, 0) fails")
            return psum(x, "data")

        shard_map(body, mesh=mesh, in_specs=(P("data"),),
                  out_specs=P("data"))(torch.ones(4))
        return
    telemetry.enable()
    scratch = os.path.join(out, f"scratch{pid}")
    os.makedirs(scratch, exist_ok=True)
    data = os.path.join(out, "data.npz")
    deadline = time.monotonic() + HARD_LIMIT_S
    while not os.path.exists(data):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {data}")
        time.sleep(0.05)
    with np.load(data) as z:
        X, y = z["X"], z["y"]
    arrays, scalars = _fit_all(T, mesh, X, y, out, scratch)
    scalars.update(n_global_devices=n_dev, process=pid,
                   mesh_processes=mesh.processes.tolist())
    np.savez(os.path.join(out, f"arrays{pid}.npz"), **arrays)
    with open(os.path.join(out, f"scalars{pid}.json"), "w") as f:
        json.dump(scalars, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_workers(out: str, mode: str) -> tuple[list, list, float]:
    """Both workers started: ``(processes, their logs, deadline)``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = [open(os.path.join(out, f"log{pid}.txt"), "w+")
            for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), str(port),
         out, mode], env=env, stdout=log, stderr=log, cwd=ROOT)
        for pid, log in enumerate(logs)]
    return procs, logs, time.monotonic() + HARD_LIMIT_S


def _finish_workers(procs, logs, deadline) -> list[tuple[int | None, str]]:
    """Wait for both workers until the deadline, then kill what is left;
    ``(exit code or None if killed, log tail)`` each."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    return list(zip(codes, tails))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``((worker dir, both workers' (arrays, scalars)), the 1-process
    mesh's (arrays, scalars))``: the same fits on the port's 1-process
    ``(2, 2)`` CPU mesh run here while the workers run."""
    torch = pytest.importorskip("torch")
    import spark_bagging_tpu_torch as T

    out = str(tmp_path_factory.mktemp("mh"))
    started = _start_workers(out, "fit")
    X, y = _data()
    # written whole, then renamed: the workers wait for the name
    np.savez(os.path.join(out, "data.tmp.npz"), X=X, y=y)
    os.replace(os.path.join(out, "data.tmp.npz"),
               os.path.join(out, "data.npz"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = str(tmp_path_factory.mktemp("one"))
        mesh = T.make_mesh(data=2, replica=2, devices=["cpu"] * 4)
        one_process = _fit_all(T, mesh, X, y, one, one)
    finally:
        torch.set_num_threads(n)
        finished = _finish_workers(*started)
    for code, tail in finished:
        assert code == 0, f"worker failed (exit {code}):\n{tail}"
    results = []
    for pid in range(2):
        with np.load(os.path.join(out, f"arrays{pid}.npz")) as z:
            arrays = dict(z)
        with open(os.path.join(out, f"scalars{pid}.json")) as f:
            results.append((arrays, json.load(f)))
    return (out, results), one_process


@pytest.fixture(scope="module")
def workers(runs):
    return runs[0]


@pytest.fixture(scope="module")
def one_process(runs):
    return runs[1]


def _names(arrays, prefix):
    return sorted(k for k in arrays if k.startswith(prefix + "."))


def test_both_processes_agree(workers):
    """Every gathered array is bitwise the same in both processes."""
    _, ((a0, s0), (a1, s1)) = workers
    assert s0["n_global_devices"] == s1["n_global_devices"] == 2
    assert s0["mesh_processes"] == s1["mesh_processes"] == [[0, 0], [1, 1]]
    assert sorted(a0) == sorted(a1)
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    assert s0["logistic.oob_score"] == s1["logistic.oob_score"]


def test_matches_single_process_mesh(workers, one_process):
    """The 2-process fits are bitwise the 1-process (2, 2) mesh's, and
    that mesh's logistic fit and OOB are within the sharded tests'
    tolerance of JAX's (2, 2) mesh fit."""
    import jax

    import spark_bagging_tpu as J

    _, ((a0, s0), _) = workers
    arrays, scalars = one_process
    assert sorted(arrays) == sorted(a0)
    for k in arrays:
        np.testing.assert_array_equal(a0[k], arrays[k], err_msg=k)
    assert s0["logistic.oob_score"] == scalars["logistic.oob_score"]
    X, y = _data()
    j = J.BaggingClassifier(n_estimators=8, seed=1, max_features=0.8,
                            oob_score=True,
                            mesh=J.make_mesh(2, 2, devices=jax.devices()[:4])
                            ).fit(X, y)
    np.testing.assert_array_equal(arrays["logistic.subspaces"],
                                  np.asarray(j.subspaces_))
    np.testing.assert_allclose(arrays["logistic.pred"], j.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)
    np.testing.assert_allclose(arrays["logistic.oob"],
                               j.oob_decision_function_, atol=PROBA_ATOL,
                               rtol=0)


def test_multihost_stream_fit(workers):
    """The SGD stream over the 2-process mesh: chunks placed per shard,
    the gradients psum'd across processes; its resume from the mid-fit
    snapshot (step 36 of 40) is bitwise the uninterrupted fit. (Mesh
    streams against JAX's: tests/test_torch_sharded_stream.py.)"""
    _, ((a0, s0), _) = workers
    assert s0["snapshot_steps"] == 36
    for k in _names(a0, "stream"):
        np.testing.assert_array_equal(
            a0[k], a0[k.replace("stream", "stream_resumed")], err_msg=k)
    assert s0["stream.score"] > 0.9


def test_multihost_forest_fit(workers):
    """The forest's quantile edges and level tables summed across the
    process-spanning data axis train to quality."""
    _, ((_, s0), _) = workers
    assert s0["forest.score"] > 0.9


def test_multihost_aft_aux_channel(workers):
    """The censor column is placed over the data axis like y; the
    predicted survival times are positive."""
    _, ((a0, _), _) = workers
    assert (a0["aft.pred"] > 0).all()
    assert a0["aft.pred"].shape == (16,)


def test_multihost_pooled_warm_start(workers):
    """The pooled start's shared solve sums its row statistics across
    processes: one refinement step trains to quality."""
    _, ((_, s0), _) = workers
    assert s0["pooled.score"] > 0.95


def test_multihost_arrow_stream(workers):
    """Each process streams its own copy of one Arrow file through the
    process-spanning mesh."""
    _, ((_, s0), _) = workers
    assert s0["arrow.score"] > 0.9


def test_snapshot_and_checkpoint_written_by_process_zero_only(workers):
    """Only process 0 writes (checkpoint bytes saved: process 1 none);
    the checkpoint loads on one device with the gathered weights, and
    predicts what the mesh predicted."""
    import spark_bagging_tpu_torch as T

    out, ((a0, s0), (_, s1)) = workers
    assert s0["checkpoint_bytes_saved"] > 0
    assert s1["checkpoint_bytes_saved"] == 0
    assert not [p for p in os.listdir(out) if ".tmp." in p]
    loaded = T.BaggingClassifier.load(os.path.join(out, "model"),
                                      device="cpu")
    for k, v in loaded.ensemble_.items():
        np.testing.assert_array_equal(v.numpy(), a0[f"logistic.{k}"])
    X, _ = _data()
    np.testing.assert_allclose(loaded.predict_proba(X), a0["logistic.pred"],
                               atol=PROBA_ATOL, rtol=0)


def test_oob_stream_refused_as_jax(workers):
    _, ((_, s0), (_, s1)) = workers
    assert s0["oob_stream_error"] == s1["oob_stream_error"] == (
        "oob_score with fit_stream is single-process only")


def test_h2d_bytes_count_each_process_shards(workers):
    """``sbt_h2d_bytes_total{process}`` is the bytes of the process's own
    shards: one data row's block of the padded X, y and mask for the fit,
    and of X again for the OOB pass (the two positions of a row share
    the CPU, so each block is placed once); the gathers are on
    ``sbt_collective_seconds`` and ``sbt_d2h_bytes_total{process}``."""
    _, results = workers
    rows = 570 // 2
    want = 2 * rows * 30 * 4 + rows * 8 + rows * 4
    for pid, (_, s) in enumerate(results):
        got = {(name, json.dumps(labels, sort_keys=True)): value
               for name, labels, value in s["series_after_logistic"]}
        label = json.dumps({"process": str(pid)})
        assert got[("sbt_h2d_bytes_total", label)] == want
        assert got[("sbt_d2h_bytes_total", label)] > 0
        assert got[("sbt_collective_seconds", "{}")] > 0


def test_initialize_distributed_argument_errors_equal_jax():
    from spark_bagging_tpu.parallel import (
        initialize_distributed as jinit,
    )
    from spark_bagging_tpu_torch.parallel import (
        initialize_distributed as tinit,
    )

    for kw in ({"num_processes": 2}, {"process_id": 0},
               {"num_processes": 2, "process_id": 1}):
        with pytest.raises(ValueError) as je:
            jinit(**kw)
        with pytest.raises(ValueError) as te:
            tinit(**kw)
        assert str(te.value) == str(je.value)


def test_a_raising_worker_fails_both_workers(tmp_path):
    """Shard (0, 0) of process 0 raises before its psum: process 0 fails
    with that error and process 1 fails at its collective, both well
    within the hard limit (the group timeout is 10 s here)."""
    t0 = time.monotonic()
    (c0, log0), (c1, log1) = _finish_workers(
        *_start_workers(str(tmp_path), "raise"))
    assert c0 not in (0, None), log0
    assert c1 not in (0, None), log1
    assert "shard (0, 0) fails" in log0
    assert time.monotonic() - t0 < HARD_LIMIT_S / 2


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _pid, _port, _out, _mode = sys.argv[1:5]
    try:
        _worker(int(_pid), int(_port), _out, _mode)
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        # a failed worker exits at once: no teardown may wait on a peer
        os._exit(1)
