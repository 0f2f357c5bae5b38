"""The ``fit.higgs_gbt`` cell at a size the CPU holds (CPU): a whole run
reads correct and a broken learner reads not correct under the cell's
own limits; the program's readings pass the limits and the control's
(bfloat16 leaf sums and margins) fail them; the configuration's counts
of work give their known answers; and the cell's four readers give
theirs on a hand-made trace, and nothing on a program without the
boosting spans.

The CPU runs the configuration with ``hist_dtype="float32"``: the port's
CPU path sums the moments unrounded whatever ``hist_dtype`` says, and
the reference rounds them only where the configuration says bfloat16.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import control  # noqa: E402
from bench import cell, drive  # noqa: E402
from bench.drive import Call  # noqa: E402
from bench.trace import WINDOW, Trace  # noqa: E402
from counts import gbt_newton, peaks  # noqa: E402

# a whole fit has to end inside the 2-s window
torch.set_num_threads(2)

import spark_bagging_tpu_torch as port  # noqa: E402
from spark_bagging_tpu_torch import ensemble  # noqa: E402

NAME = "fit.higgs_gbt"
SIZES = {"data": {"n_rows": 3000, "n_predict_rows": 500},
         "estimator": {"params": {"n_estimators": 4},
                       "learner": {"params": {"n_rounds": 5,
                                              "hist_dtype": "float32"}}},
         "check": {"replicas": 4}}


def _run(seed: int = 2**31 + 24) -> dict:
    c = cell.load(NAME, ROOT)
    return drive.run(c, seed, 2.0, False, time.perf_counter(), device="cpu",
                     sizes=SIZES, log=open(os.devnull, "w"))


def _unchanged(mp):
    """The learner's fit returns the state it was given."""
    def fit(self, params, X, y, sample_weight, keys, **kw):
        return params, {"loss": torch.zeros(params["f0"].shape[0])}

    mp.setattr(port.GBTClassifier, "fit", fit)


def _half_rows(mp):
    """Half the rows left out of every replica's weights."""
    orig = ensemble.bootstrap_weights

    def weights(k, ids, n_rows, **kw):
        w = orig(k, ids, n_rows, **kw).clone()
        w[:, n_rows // 2:] = 0.0
        return w

    mp.setattr(ensemble, "bootstrap_weights", weights)


def _threshold_up(mp):
    """Every replica's first split one float up from where the fit put
    it."""
    orig = port.GBTClassifier.fit

    def fit(self, *a, **kw):
        params, aux = orig(self, *a, **kw)
        params = dict(params)
        t = params["threshold"].clone()
        t[:, 0] = torch.nextafter(t[:, 0], torch.tensor(float("inf")))
        params["threshold"] = t
        return params, aux

    mp.setattr(port.GBTClassifier, "fit", fit)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"split_gap", "leaf_gap", "margin_gap"}
    assert set(res["metrics"]) == {"setup_s", "fit_replicas_per_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _threshold_up],
                         ids=["unchanged", "half_rows", "threshold_up"])
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**33 + 7, 12345])
def test_program_passes_and_control_fails_the_limits(seed):
    c = cell.load(NAME, ROOT)
    prog = control.readings(c, seed, False, device="cpu", sizes=SIZES)
    ctl = control.readings(c, seed, True, device="cpu", sizes=SIZES)
    assert drive.judge(prog, c.limits)[0] is True, prog
    assert drive.judge(ctl, c.limits)[0] is False, ctl
    assert any(ctl[k] >= 3 * max(prog[k], 1e-12) and ctl[k] > c.limits[k]
               for k in ctl)


# -- counts ----------------------------------------------------------------

def _config():
    with open(os.path.join(HERE, "configs", "higgs_gbt.json")) as f:
        return json.load(f)


def test_counts_of_the_configuration():
    cfg = _config()
    s = gbt_newton.shape(cfg)
    assert (s["n"], s["F"], s["k"], s["B"], s["D"], s["M"], s["R"]) == \
        (800_000, 28, 28, 32, 4, 30, 32)
    # the kernel table's config-7 bound (X read as float32 in place of
    # the one-byte codes): 0.149 ... 0.150 ms a launch
    for lv in range(4):
        ms = 1e3 * gbt_newton.level_bytes(s, lv, code_bytes=4.0) / peaks.BYTES
        assert 0.149 <= ms <= 0.151
    # with the codes the kernel reads: codes, moments, node ids, edges,
    # the int64 table
    n, R = 800_000, 32
    nbytes = (n * 28 + 4.0 * R * n * 3 + 4.0 * R * n + 4.0 * R * 28 * 32
              + 8.0 * R * 28 * 32 * 8 * 3)
    assert gbt_newton.level_least_seconds(s, 3) == pytest.approx(
        nbytes / peaks.BYTES)
    assert gbt_newton.codes_least_seconds(s) == pytest.approx(
        5.0 * n * 28 / peaks.BYTES)
    assert 1e3 * gbt_newton.hist_least_seconds(cfg) == pytest.approx(
        15.6046, abs=1e-3)
    assert gbt_newton.fit_flops(cfg) == 276_759_746_560.0


# -- the four readers ------------------------------------------------------

READERS = ("boost_ms.fit", "leaf_ms.fit", "round_idle_ms.fit",
           "hist_fixed_roofline")


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _range(name, ts, end):
    return _ev("user_annotation", name, ts, end - ts)


def _op(name, launch, ts, end, corr):
    return [_ev("cuda_runtime", "cudaLaunchKernel", launch, 1,
                correlation=corr),
            _ev("kernel", name, ts, end - ts, tid=7, correlation=corr)]


def _trace(boosting=True):
    """One fit in a 1000-us window (times in us). ``bin_codes`` in the
    prepare; two ``boost_round`` ranges, 110-400 and 410-800, each with a
    ``tree_level`` and a ``leaf_stats``, the first level with a
    ``histogram``; a ``tree_level`` outside the rounds. Without
    ``boosting``, the parent's program: no ``boost_round`` and no
    ``leaf_stats`` range."""
    ranges = [_range(WINDOW, 0, 1000), _range("fit_prepare", 50, 90),
              _range("bin_codes", 60, 70), _range("learner_fit", 100, 900),
              _range("tree_level", 120, 200), _range("histogram", 130, 150),
              _range("tree_level", 420, 500), _range("tree_level", 850, 880)]
    if boosting:
        ranges += [_range("boost_round", 110, 400),
                   _range("leaf_stats", 210, 250),
                   _range("boost_round", 410, 800),
                   _range("leaf_stats", 510, 560)]
    ops = (_op("bin_codes_kernel", 65, 70, 75, 1)
           + _op("hist_partial", 135, 140, 170, 2)
           + _op("split_search", 180, 180, 190, 3)
           + _op("leaf_bmm", 220, 225, 245, 4)
           + _op("sigmoid", 300, 300, 340, 5)
           + _op("route", 430, 430, 450, 6)
           + _op("leaf_bmm", 520, 520, 530, 7)
           + _op("margin", 600, 600, 615, 8)
           + _op("route", 860, 860, 870, 9))
    return Trace(ranges + ops)


def _view(trace):
    return SimpleNamespace(
        trace=trace, calls=[Call(0.0, 1.0, 32.0)], config={},
        counts=SimpleNamespace(hist_least_seconds=lambda cfg: 7e-6))


def test_readers_known_answers():
    run = _view(_trace())
    got = {m: cell.reader(m)(run) for m in READERS}
    # under the rounds 145 us, of it 90 under their levels and leaf sums
    assert got["boost_ms.fit"] == pytest.approx(0.055)
    assert got["leaf_ms.fit"] == pytest.approx(0.030)
    # the rounds' union is 680 us, 145 of it busy
    assert got["round_idle_ms.fit"] == pytest.approx(0.535)
    # 7 us of least time over the 35 us under histogram and bin codes
    assert got["hist_fixed_roofline"] == pytest.approx(20.0)


def test_readers_on_a_program_without_the_spans():
    run = _view(_trace(boosting=False))
    for m in ("boost_ms.fit", "leaf_ms.fit", "round_idle_ms.fit"):
        assert cell.reader(m)(run) is None, m
    assert cell.reader("hist_fixed_roofline")(run) == pytest.approx(20.0)
    run.counts = SimpleNamespace()
    assert cell.reader("hist_fixed_roofline")(run) is None
