"""The tree-vote kernel's roofline share (``tree_vote_roofline``), on
hand-made traces with known answers (CPU): the least time of a call at
config 3's shapes, device time of the operations launched inside the
``tree_vote`` range and nothing else, and nothing read from a program
without the range or from another learner's configuration."""

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

NAME = "tree_vote_roofline"
# 4 m F + 8 R (2^D - 1) + 4 R 2^D C + 4 m C bytes at config 3 (m =
# 581,012, F = 54, C = 7, R = 256, D = 5) over 3.35 TB/s; its m R D
# compares on the fp32 cores take 11.1 us
LEAST_S = 142_059_792 / 3.35e12


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _trace(with_range=True):
    """Two predict calls in a 200-us window, each a ``predict_forward``
    range holding one ``tree_vote`` range (a 3-us argmax of the leaf
    table and a 9-us kernel launched in it), a 5-us scale launched
    after it and a 30-us HtoD copy before."""
    ev = [_ev("user_annotation", WINDOW, 0, 200)]
    for k, t in enumerate((0, 100)):
        c = 10 * k
        ev += [_ev("user_annotation", "predict_forward", t + 40, 40),
               _ev("cuda_runtime", "cudaMemcpyAsync", t + 1, 1,
                   correlation=c + 1),
               _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 2,
                   30, tid=7, correlation=c + 1)]
        if with_range:
            ev.append(_ev("user_annotation", "tree_vote", t + 41, 20))
        for j, (ts, dur, name) in enumerate(((42, 3, "reduce_kernel"),
                                             (50, 9, "tree_vote"))):
            ev += [_ev("cuda_runtime", "cudaLaunchKernel", t + ts, 1,
                       correlation=c + 2 + j),
                   _ev("kernel", name, t + ts + 1, dur, tid=7,
                       correlation=c + 2 + j)]
        ev += [_ev("cuda_runtime", "cudaLaunchKernel", t + 75, 1,
                   correlation=c + 5),
               _ev("kernel", "vectorized_elementwise_kernel", t + 76, 5,
                   tid=7, correlation=c + 5)]
    return Trace(ev)


def _run(trace, config="covtype_trees", calls=2):
    return SimpleNamespace(trace=trace, config=_config(config),
                           counts=tree_gini, calls=[Call(0.0, 1.0, 1.0)] * calls)


def test_least_time_of_a_config3_call():
    # 142.06 MB of X, tables and counts bound it: 42.41 us
    mod = cell._from_file("metrics", NAME, HERE)
    least = mod.least_seconds(_config("covtype_trees"))
    assert least == pytest.approx(LEAST_S, rel=1e-12)
    assert 1e6 * least == pytest.approx(42.406, abs=1e-3)


def test_share_reads_the_device_time_under_the_range():
    # 24 us of kernels under the ranges for two calls: 12 us a call
    got = cell.reader(NAME)(_run(_trace()))
    assert got == pytest.approx(100.0 * LEAST_S / 12e-6, rel=1e-9)


@pytest.mark.parametrize("case", ["no_range", "no_calls", "logistic"])
def test_reads_nothing_without_the_range_or_the_trees(case):
    run = {"no_range": lambda: _run(_trace(with_range=False)),
           "no_calls": lambda: _run(_trace(), calls=0),
           "logistic": lambda: SimpleNamespace(
               trace=_trace(), config=_config("covtype_logistic"),
               counts=logistic_newton,
               calls=[Call(0.0, 1.0, 1.0)] * 2)}[case]()
    assert cell.reader(NAME)(run) is None
