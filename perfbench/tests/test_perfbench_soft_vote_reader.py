"""The soft-vote kernel's roofline share (``soft_vote_roofline``), on
hand-made traces with known answers (CPU): the least time of a call at
the headline's shapes, device time of the operations launched inside the
``soft_vote`` range and nothing else, and nothing read from a program
without the range."""

import json
import os
import sys
from types import SimpleNamespace

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE]

from bench import cell  # noqa: E402
from bench.drive import Call  # noqa: E402
from bench.trace import WINDOW, Trace  # noqa: E402
from counts import logistic_newton, tree_gini  # noqa: E402

NAME = "soft_vote_roofline"


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace(with_range=True):
    """Two predict calls in a 200-us window, each a ``predict_forward``
    range with two ``soft_vote`` ranges inside (a 10-us and a 6-us
    kernel launched in them), a 5-us sum launched outside them and a
    30-us HtoD copy before."""
    ev = [_ev("user_annotation", WINDOW, 0, 200)]
    for k, t in enumerate((0, 100)):
        c = 10 * k
        ev += [_ev("user_annotation", "predict_forward", t + 40, 40),
               _ev("cuda_runtime", "cudaMemcpyAsync", t + 1, 1,
                   correlation=c + 1),
               _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 2,
                   30, tid=7, correlation=c + 1)]
        for j, (ts, dur) in enumerate(((42, 10), (60, 6))):
            if with_range:
                ev.append(_ev("user_annotation", "soft_vote", t + ts, 3))
            ev += [_ev("cuda_runtime", "cudaLaunchKernel", t + ts + 1, 1,
                       correlation=c + 2 + j),
                   _ev("kernel", "soft_vote_wgmma", t + ts + 2, dur, tid=7,
                       correlation=c + 2 + j)]
        ev += [_ev("cuda_runtime", "cudaLaunchKernel", t + 75, 1,
                   correlation=c + 5),
               _ev("kernel", "reduce_kernel", t + 76, 5, tid=7,
                   correlation=c + 5)]
    return Trace(ev)


def _run(trace, config="covtype_logistic", counts=logistic_newton, calls=2):
    return SimpleNamespace(trace=trace, config=_config(config),
                           counts=counts, calls=[Call(0.0, 1.0, 1.0)] * calls)


def test_least_time_of_a_headline_call():
    # 447.4 GFLOP at 165 TFLOP/s (3xTF32) bounds it: 2.7114 ms, against
    # 143 MB of bytes, 0.043 ms
    mod = cell._from_file("metrics", NAME, HERE)
    least = mod.least_seconds(_config("covtype_logistic"), logistic_newton)
    assert 1e3 * least == pytest.approx(2.71139, abs=1e-4)


def test_share_reads_the_device_time_under_the_range():
    # 32 us of kernels under the ranges for two calls: 16 us a call
    got = cell.reader(NAME)(_run(_trace()))
    assert got == pytest.approx(100.0 * 2.711389333e-3 / 16e-6, rel=1e-6)


@pytest.mark.parametrize("case", ["no_range", "no_calls", "trees"])
def test_reads_nothing_without_the_range_or_the_counts(case):
    run = {"no_range": lambda: _run(_trace(with_range=False)),
           "no_calls": lambda: _run(_trace(), calls=0),
           "trees": lambda: _run(_trace(), "covtype_trees", tree_gini)}[case]()
    assert cell.reader(NAME)(run) is None
