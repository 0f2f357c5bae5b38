"""One cell run for 10 s on the card through the benchmark's command,
and the keys of its last line (needs an NVIDIA GPU: run with
``python -m pytest perfbench/tests -m cuda`` on the card)."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _run(*args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=900)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card_and_prints_the_contract_line():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = _run("--workload", "fit.covtype_trees", "--seed", str(2**31 + 3),
               "--seconds", "10", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "fit_replicas_per_s"}
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] > 0
    # the compared numbers are the last lines of standard error
    tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("--workload", "fit.covtype_trees", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
