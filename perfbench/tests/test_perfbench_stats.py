"""The rate, percentile and idle arithmetic, and the trace reader, on
hand-made numbers and intervals (CPU)."""

import os
import sys

import pytest

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from bench import stats  # noqa: E402
from bench.trace import WINDOW, Trace  # noqa: E402


def test_window_rate_counts_whole_calls_to_the_last_end():
    # 3 fits of 1000 replicas ending at 3, 6.5 and 10 s after the start
    assert stats.window_rate([1000] * 3, [3.0, 6.5, 10.0], 0.0) == pytest.approx(300)
    assert stats.window_rate([], [], 0.0) is None


def test_window_rate_with_a_stall_counts_the_stall():
    # the same 3 calls, the last one after a 5 s stall: the stall is time
    assert stats.window_rate([10] * 3, [1.0, 2.0, 8.0], 0.0) == pytest.approx(30 / 8)


def test_percentile_is_over_every_value():
    vals = [10.0] * 95 + [100.0] * 5
    assert stats.percentile(vals, 95) == pytest.approx(14.5)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union_length(iv) == pytest.approx(3 + 1 + 3)
    assert stats.union_length(iv, 1, 10) == pytest.approx(2 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.idle_share(iv, 0, 10) == pytest.approx(0.5)


def test_idle_share_of_a_window_with_a_stall():
    # busy 0-4, a 4 s stall, busy 8-10
    assert stats.idle_share([(0, 4), (8, 10)], 0, 10) == pytest.approx(0.4)
    with pytest.raises(ValueError):
        stats.idle_share([], 1, 1)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    # a 100 us window: fit range 0-90 (h2d 0-10 inside, bootstrap
    # 20-30 inside); kernels 25-35 (launched at 21, in the bootstrap
    # range), 40-50 and 88-92, a memcpy 60-70 (launched at 2, in h2d):
    # a stall 70-88 in the fit, and 92-100 outside any range
    return Trace([
        _ev("user_annotation", WINDOW, 0, 100),
        _ev("user_annotation", "perfbench:fit", 0, 90),
        _ev("user_annotation", "h2d", 0, 10),
        _ev("user_annotation", "bootstrap_weights", 20, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 35, 1, correlation=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 2, 1, correlation=3),
        _ev("kernel", "void scaled_gram_mma<false>(GramArgs)", 25, 10,
            correlation=1),
        _ev("kernel", "elementwise_kernel", 40, 10, correlation=2),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 10,
            correlation=3),
        _ev("kernel", "reduce_kernel", 88, 4),
        {"ph": "i", "name": "marker", "ts": 1},
    ])


def test_trace_busy_idle_and_names():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(34e-6)
    assert tr.busy_s(cats=("kernel",)) == pytest.approx(24e-6)
    assert tr.device_seconds(("kernel",), names=("scaled_gram_mma",)) \
        == pytest.approx(10e-6)
    assert tr.device_seconds(("gpu_memcpy",), names=("HtoD",)) \
        == pytest.approx(10e-6)
    assert tr.seconds_under_range("bootstrap_weights") == pytest.approx(10e-6)
    assert tr.seconds_under_range("no_such_range") is None
    assert tr.range_seconds("h2d") == [pytest.approx(10e-6)]
    gaps = dict(tr.idle_gaps())
    # 0-25, 35-40, 50-60 and 70-88 in the fit; 92-100 in no range
    assert gaps["perfbench:fit"] == pytest.approx((25 + 5 + 10 + 18) * 1e-6)
    assert gaps["(no range)"] == pytest.approx(8e-6)
    assert tr.top_device_ops()[0][1] == pytest.approx(10e-6)


def test_trace_needs_one_window():
    with pytest.raises(RuntimeError):
        Trace([_ev("kernel", "k", 0, 1)])
