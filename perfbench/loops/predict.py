"""The ``predict`` loop: a Spark-style transform of a whole table, one
caller.

Set-up fits the configuration once (index -1: state the traffic needs)
and warms the call once. Each call is ``predict_proba`` of every
predict row by that ensemble (``ensemble.predict_ensemble_classifier``:
soft vote for probabilities, hard vote for votes); it counts the rows.
The first call's output, a share drawn from the run's seed and the
last are kept; the check compares the state fit with the reference as
a fit cell does, and the kept outputs with the reference's forward over
the program's state.
"""

import numpy as np

from bench import drive, program

SPAN = "predict_proba"
TRACE_CALLS = 30
KEEP_SHARE = 0.05


def setup(run) -> None:
    with run.spans("state_fit"):
        s = program.call_seed(run.seed, -1)
        run.state = program.build(run.config, s, run.device)
        run.state.fit(run.X, run.y)
        run.sync()
        run.state_record = program.record(run.state, s)
    with run.spans("warm_call"):
        run.state.predict_proba(run.Xp)
    run.keep_rng = np.random.default_rng([int(run.seed) % 2**63, 5])
    run.last = None


def call(run, i: int):
    out = run.state.predict_proba(run.Xp)
    run.last = out
    keep = i == 0 or run.keep_rng.random() < KEEP_SHARE
    return run.config["data"]["n_predict_rows"], (out if keep else None)


def numbers(run, ref) -> dict:
    R = int(run.config["estimator"]["params"]["n_estimators"])
    pairs = drive.sample_pairs(run.seed, 1, R,
                               int(run.config["check"]["replicas"]))
    out = ref.fit_numbers([run.state_record], pairs)
    kept = list(run.records)
    if run.last is not None and not any(k is run.last for k in kept):
        kept.append(run.last)
    if kept:
        out.update(ref.predict_numbers(run.state_record, kept))
    return out


def control(run, ref) -> None:
    """The reference's lower-precision forward over the program's state
    in the program's place."""
    run.records = [ref.control_predict(run.state_record)]
    run.last = None
