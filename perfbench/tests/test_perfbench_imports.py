"""What the benchmark's processes load (CPU): no module whose top-level
name, compared whole, is ``jax``, ``jaxlib``, ``flax`` or
``spark_bagging_tpu``; and the references load nothing of the port."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
METRICS = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                 if f.endswith(".py"))
LOOPS = sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "loops"))
               if f.endswith(".py"))


def _run(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_then_port_then_reference_load_no_jax():
    got = _run(f"""
import json, sys
sys.path[:0] = [{HERE!r}, {ROOT!r}]
from bench import cell, data, drive, guard, program, stats, trace
import spark_bagging_tpu_torch
from spark_bagging_tpu_torch import telemetry
import counts.logistic_newton, counts.tree_gini
import reference.logistic_newton, reference.tree_gini, reference.threefry
for m in {METRICS!r}:
    cell.reader(m)
for name in {LOOPS!r}:
    cell.loop(name)
print(json.dumps({{"forbidden": guard.forbidden_modules(),
                  "port": "spark_bagging_tpu_torch" in sys.modules}}))
""")
    assert got == {"forbidden": [], "port": True}


def test_reference_loads_nothing_of_the_port():
    got = _run(f"""
import json, sys
sys.path[:0] = [{HERE!r}, {ROOT!r}]
import reference.logistic_newton, reference.tree_gini, reference.threefry
import counts.logistic_newton, counts.tree_gini
from bench import guard
print(json.dumps({{"forbidden": guard.forbidden_modules(),
                  "port": sorted(m for m in sys.modules
                                 if m.split(".")[0] == "spark_bagging_tpu_torch")}}))
""")
    assert got == {"forbidden": [], "port": []}


def test_a_whole_run_loads_no_jax():
    """A run of a cell at a size the CPU holds, then the guard's look."""
    got = _run(f"""
import json, sys, time
sys.path[:0] = [{HERE!r}, {ROOT!r}]
from bench import cell, drive, guard
c = cell.load("predict.covtype_trees", {ROOT!r})
sizes = {{"data": {{"n_rows": 2000, "n_predict_rows": 1000}},
          "estimator": {{"params": {{"n_estimators": 4}}}},
          "check": {{"replicas": 3}}}}
res = drive.run(c, 5, 0.5, True, time.perf_counter(), device="cpu",
                sizes=sizes)
print(json.dumps({{"forbidden": guard.forbidden_modules(),
                  "correct": res["correct"]}}))
""")
    assert got == {"forbidden": [], "correct": True}


def test_guard_compares_whole_top_level_names():
    sys.path[:0] = [HERE]
    from bench import guard

    assert guard.forbidden_modules(["spark_bagging_tpu_torch",
                                    "spark_bagging_tpu_torch.ops",
                                    "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["jax.numpy", "spark_bagging_tpu.ops",
                                    "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "spark_bagging_tpu.ops"]
