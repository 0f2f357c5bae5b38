"""The readers of the program's spans and ranges, on hand-made traces
with known answers (CPU): self time of nested ranges, device time of
launches tied by ``correlation`` to a range, an operation launched under
both the histogram and the bin-codes range counted once, idle time
inside a union of ranges, and nothing read from a program without the
spans."""

import os
import sys
from types import SimpleNamespace

import pytest

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from bench import cell  # noqa: E402
from bench.drive import Call  # noqa: E402
from bench.trace import WINDOW, Trace  # noqa: E402

FIT_READERS = ("estimator_self_ms.fit", "prepare_ms.fit", "chunks.fit",
               "engine_idle_ms.fit", "learner_ms.fit", "gram_ms.fit",
               "hist_ms.fit")
PREDICT_READERS = ("h2d_host_ms.predict", "d2h_ms.predict")


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _range(name, ts, end, tid=1):
    return _ev("user_annotation", name, ts, end - ts, tid=tid)


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def _op(name, ts, end, corr, cat="kernel"):
    return _ev(cat, name, ts, end - ts, tid=7, correlation=corr)


def _fit_trace():
    """One fit in a 1000-us window (times in us). The engine's ranges:
    ``fit_prepare`` 110-200 (a Newton step and a Gram inside), two
    ``replica_chunk`` ranges 210-450 and 460-690, each with its
    ``learner_fit``; in the second a ``histogram`` range with a
    ``bin_codes`` range inside it, then a ``bin_codes`` range alone. A
    harness range and another thread's range lie inside
    ``estimator_fit`` too."""
    return Trace([
        _range(WINDOW, 0, 1000),
        _range("perfbench:fit", 0, 900),
        _range("estimator_fit", 10, 890),
        _range("h2d", 20, 60),
        _range("fit", 100, 700),
        _range("fit_prepare", 110, 200),
        _range("newton_step", 120, 150),
        _range("scaled_grams", 125, 130),
        _range("replica_chunk", 210, 450),
        _range("bootstrap_weights", 215, 230),
        _range("learner_fit", 240, 440),
        _range("scaled_grams", 250, 260),
        _range("replica_chunk", 460, 690),
        _range("learner_fit", 470, 680),
        _range("histogram", 480, 500),
        _range("bin_codes", 485, 490),
        _range("bin_codes", 600, 610),
        _range("aggregate", 710, 720),
        _range("quality_profile", 730, 800),
        _range("perfbench:probe", 820, 850),
        _range("other_thread", 820, 860, tid=2),
        _launch(30, 8), _op("Memcpy HtoD (Pageable -> Device)", 30, 60, 8,
                            cat="gpu_memcpy"),
        _launch(126, 1), _op("scaled_gram_mma", 130, 140, 1),
        _launch(140, 2), _op("elementwise_kernel", 150, 170, 2),
        _launch(220, 3), _op("threefry_kernel", 230, 260, 3),
        _launch(255, 4), _op("scaled_gram_mma", 260, 300, 4),
        _launch(487, 5), _op("bin_codes_kernel", 490, 495, 5),
        _launch(495, 6), _op("hist_partial", 500, 520, 6),
        _launch(605, 7), _op("bin_codes_kernel", 610, 617, 7),
    ])


def _predict_trace():
    """Two predict calls in a 200-us window, each: ``predict_h2d`` 30 us
    over its HtoD copy, ``predict_forward`` launching the forward,
    ``predict_d2h`` 52 us over a 10-us DtoH copy."""
    ev = [_range(WINDOW, 0, 200)]
    for k, t in enumerate((0, 100)):
        c = 10 * k
        ev += [
            _range("perfbench:predict_proba", t, t + 95),
            _range("estimator_predict", t + 1, t + 94),
            _range("predict_h2d", t + 2, t + 32),
            _launch(t + 3, c + 1),
            _op("Memcpy HtoD (Pageable -> Device)", t + 3, t + 31, c + 1,
                cat="gpu_memcpy"),
            _range("predict_forward", t + 33, t + 40),
            _launch(t + 35, c + 2), _op("gemm", t + 36, t + 80, c + 2),
            _range("predict_d2h", t + 41, t + 93),
            _launch(t + 42, c + 3),
            _op("Memcpy DtoH (Device -> Pageable)", t + 81, t + 91, c + 3,
                cat="gpu_memcpy"),
        ]
    return Trace(ev)


def _run(trace, n_calls):
    return SimpleNamespace(trace=trace,
                           calls=[Call(0.0, 1.0, 1.0)] * n_calls)


def _read(name, run):
    return cell.reader(name)(run)


@pytest.mark.parametrize("name, want", [
    # 880 us in estimator_fit less h2d 40, fit 600, aggregate 10 and
    # quality_profile 70; the harness's range and thread 2's do not count
    ("estimator_self_ms.fit", 0.160),
    # the Gram and the elementwise kernel launched in fit_prepare
    ("prepare_ms.fit", 0.030),
    ("chunks.fit", 2),
    # idle in [110, 200] 60, [210, 450] 170, [460, 690] 198
    ("engine_idle_ms.fit", 0.428),
    # the second Gram, the codes inside the histogram, the histogram
    # and the codes alone; the bootstrap's draw is outside learner_fit
    ("learner_ms.fit", 0.072),
    ("gram_ms.fit", 0.050),
    # the codes launched under both ranges count once: 5 + 20 + 7
    ("hist_ms.fit", 0.032),
])
def test_fit_readers_known_answers(name, want):
    assert _read(name, _run(_fit_trace(), 1)) == pytest.approx(want)


def test_fit_readers_divide_by_the_fits():
    run = _run(_fit_trace(), 2)
    assert _read("chunks.fit", run) == pytest.approx(1)
    assert _read("learner_ms.fit", run) == pytest.approx(0.036)
    # one estimator_fit range: the self time is of that fit
    assert _read("estimator_self_ms.fit", run) == pytest.approx(0.160)


@pytest.mark.parametrize("name, want", [
    ("h2d_host_ms.predict", 0.030),
    ("d2h_ms.predict", 0.010),
])
def test_predict_readers_known_answers(name, want):
    assert _read(name, _run(_predict_trace(), 2)) == pytest.approx(want)


def test_hist_reader_leaves_the_trace_as_it_was():
    tr = _fit_trace()
    names = [r["name"] for r in tr.ranges]
    _read("hist_ms.fit", _run(tr, 1))
    assert [r["name"] for r in tr.ranges] == names
    assert tr.seconds_under_range("bin_codes") == pytest.approx(12e-6)


@pytest.mark.parametrize("name", FIT_READERS + PREDICT_READERS)
def test_readers_find_nothing_without_the_program_spans(name):
    """A program without these spans (the parent of the change that
    added them) gives no number, and no reader raises."""
    tr = Trace([
        _range(WINDOW, 0, 100),
        _range("perfbench:fit", 0, 90),
        _range("h2d", 2, 20),
        _range("fit", 25, 80),
        _launch(30, 1), _op("scaled_gram_mma", 31, 60, 1),
    ])
    assert _read(name, _run(tr, 1)) is None
    assert _read(name, _run(_fit_trace(), 0)) is None
