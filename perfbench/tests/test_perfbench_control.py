"""The control of each cell at a size the CPU holds: the program's
readings pass the cell's limits and the control's fail them (the same
readings ``control.py`` takes on the card at the cells' own size)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import control  # noqa: E402
from bench import cell, drive  # noqa: E402

CELLS = ["fit.covtype_logistic", "fit.covtype_trees",
         "predict.covtype_logistic", "predict.covtype_trees"]


def _sizes(name):
    n, R = 6_000, 6
    return {"data": {"n_rows": n, "n_predict_rows": 1500},
            "estimator": {"params": {"n_estimators": R}},
            "check": {"replicas": R}}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 1, 2**33 + 7, 12345])
def test_program_passes_and_control_fails_the_limits(name, seed):
    c = cell.load(name, ROOT)
    prog = control.readings(c, seed, False, device="cpu",
                            sizes=_sizes(name))
    ctl = control.readings(c, seed, True, device="cpu",
                           sizes=_sizes(name))
    assert drive.judge(prog, c.limits)[0] is True, prog
    assert drive.judge(ctl, c.limits)[0] is False, ctl
    # the control fails a number by a wide margin, not at the edge
    assert any(ctl[k] >= 3 * max(prog[k], 1e-12) and ctl[k] > c.limits[k]
               for k in ctl)
