"""The harness finds a cell's configuration, traffic mix and its loop,
limits and metrics by name, and a new cell whose mix drives a loop of a
new kind, with a new end-to-end and a new per-layer metric, made of new
files and new entries, runs with no existing file edited (CPU)."""

import hashlib
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from bench import cell, drive  # noqa: E402


def test_loader_finds_each_part_by_name():
    spec = cell.benchmark(ROOT)
    for w in spec["workloads"]:
        c = cell.load(w["name"], ROOT)
        assert c.config["name"] == w["config"]
        loop = cell.loop(c.traffic["loop"])
        for part in ("setup", "call", "numbers", "control"):
            assert callable(getattr(loop, part))
        assert loop.SPAN and loop.TRACE_CALLS >= 1
        assert c.traffic["loop"] in c.config["control"]
        assert c.limits
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert c.per_layer and len(c.end_to_end) >= 2
        for m in c.end_to_end + c.per_layer:
            assert callable(cell.reader(m["name"]))
        cell.module("reference", c.config["family"]).Reference
        cell.module("counts", c.config["family"])


def _digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha1(
                        fh.read()).hexdigest()
    return out


NEW_LOOP = '''"""A loop of a new kind: labels of half the predict rows."""
from bench import drive, program

SPAN = "predict"
TRACE_CALLS = 2


def setup(run):
    s = program.call_seed(run.seed, -1)
    run.state = program.build(run.config, s, run.device)
    run.state.fit(run.X, run.y)
    run.state_record = program.record(run.state, s)


def call(run, i):
    half = run.Xp[: len(run.Xp) // 2]
    return len(half), run.state.predict(half)


def numbers(run, ref):
    R = run.config["estimator"]["params"]["n_estimators"]
    pairs = drive.sample_pairs(run.seed, 1, R, run.config["check"]["replicas"])
    return ref.fit_numbers([run.state_record], pairs)


def control(run, ref):
    pass
'''


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root / "perfbench")
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "covtype_trees.json").read_text())
    cfg.update(name="tiny_trees")
    cfg["estimator"]["params"]["n_estimators"] = 4
    cfg["data"].update(n_rows=1500, n_predict_rows=800)
    cfg["check"]["replicas"] = 2
    cfg["control"]["half_labels"] = {"reference": "none"}
    (pb / "configs" / "tiny_trees.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "half_labels.json").write_text(json.dumps(
        {"loop": "half_labels", "why": "test"}))
    (pb / "loops" / "half_labels.py").write_text(NEW_LOOP)
    (pb / "limits" / "labels.tiny_trees.json").write_text(json.dumps(
        json.loads((pb / "limits" / "fit.covtype_trees.json").read_text())))
    (pb / "metrics" / "labels_per_s.py").write_text(
        "from bench import stats\n\n\ndef read(run):\n"
        "    return stats.window_rate([c.units for c in run.calls],\n"
        "                             [c.end for c in run.calls],\n"
        "                             run.window_start)\n")
    (pb / "metrics" / "calls.labels.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_trees", "source": "test",
                            "file": "perfbench/configs/tiny_trees.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "labels.tiny_trees",
                              "config": "tiny_trees", "traffic": "half_labels",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "labels_per_s", "unit": "rows/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["labels.tiny_trees"]})
    spec["per_layer"].append({"name": "calls.labels", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "labels_per_s",
                              "workloads": ["labels.tiny_trees"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root / "perfbench")
    assert {k: after[k] for k in before} == before  # nothing edited

    c = cell.load("labels.tiny_trees", str(root))
    assert c.config["name"] == "tiny_trees"
    assert [m["name"] for m in c.per_layer] == ["calls.labels"]
    res = drive.run(c, 3, 0.5, True, time.perf_counter(), device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["calls.labels"]["value"] >= 1
    res = drive.run(c, 4, 0.5, False, time.perf_counter(), device="cpu")
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"setup_s", "labels_per_s"}
    assert res["metrics"]["labels_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"
