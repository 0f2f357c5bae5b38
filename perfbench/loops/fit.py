"""The ``fit`` loop: a user running fit jobs back to back, one caller.

Each call is ``fit(X, y)`` of a fresh estimator of the configuration on
the host arrays, with its own bagging seed from the run's seed and the
call's index; it counts the configuration's replicas. Set-up warms
every shape with one whole fit at the cell's size (index -1, not
judged). The check compares a sample of (fit, replica) pairs of the
window's fits, drawn from the run's seed, with the reference.
"""

from bench import drive, program

SPAN = "fit"
TRACE_CALLS = 3


def _fit(run, index: int) -> dict:
    s = program.call_seed(run.seed, index)
    est = program.build(run.config, s, run.device)
    est.fit(run.X, run.y)
    run.sync()
    return program.record(est, s)


def setup(run) -> None:
    with run.spans("warmup_fit"):
        _fit(run, -1)


def call(run, i: int):
    return run.config["estimator"]["params"]["n_estimators"], _fit(run, i)


def numbers(run, ref) -> dict:
    if not run.records:
        return {}
    R = int(run.config["estimator"]["params"]["n_estimators"])
    pairs = drive.sample_pairs(run.seed, len(run.records), R,
                               int(run.config["check"]["replicas"]))
    return ref.fit_numbers(run.records, pairs)


def control(run, ref) -> None:
    """The reference's lower-precision fit in the program's place: each
    kept fit's judged replicas grown again by ``ref.control_fit`` and
    laid out as a fit's state (the other replicas left zero)."""
    import torch

    R = int(run.config["estimator"]["params"]["n_estimators"])
    pairs = drive.sample_pairs(run.seed, len(run.records), R,
                               int(run.config["check"]["replicas"]))
    out = []
    for j, rec in enumerate(run.records):
        grown = ref.control_fit(rec["seed"], [r for i, r in pairs if i == j])
        if not grown:
            out.append(rec)
            continue
        state0, cols0 = next(iter(grown.values()))
        params = {k: torch.zeros((R, *v.shape), dtype=v.dtype,
                                 device=v.device) for k, v in state0.items()}
        subspaces = torch.zeros((R, *cols0.shape), dtype=cols0.dtype,
                                device=cols0.device)
        for r, (state, cols) in grown.items():
            for k, v in state.items():
                params[k][r] = v
            subspaces[r] = cols
        out.append({"seed": rec["seed"], "params": params,
                    "subspaces": subspaces})
    run.records = out
