"""The system under test: the port's estimators, built from a
configuration's ``estimator`` block by class name. This module and the
loops are the parts of the harness that call the port."""

from __future__ import annotations

import numpy as np


def build(config: dict, seed: int, device: str):
    """A fresh, unfitted estimator of the configuration with bagging
    seed ``seed``."""
    import spark_bagging_tpu_torch as port

    est = config["estimator"]
    learner = getattr(port, est["learner"]["class"])(
        **est["learner"]["params"])
    return getattr(port, est["class"])(learner, seed=int(seed) & 0xFFFFFFFF,
                                       device=device, **est["params"])


def record(estimator, seed: int) -> dict:
    """What a fit produced, kept for the check: the fitted replicas'
    state and columns, on the device they were fitted on."""
    return {"seed": int(seed) & 0xFFFFFFFF,
            "params": dict(estimator.ensemble_),
            "subspaces": estimator.subspaces_}


def call_seed(run_seed: int, index: int) -> int:
    """The bagging seed of the run's ``index``-th fit (the warm-up and
    state fits take negative indices): 32 bits from the run's seed and
    the index."""
    ss = np.random.SeedSequence([int(run_seed) % 2**63, index % 2**32,
                                 int(index < 0)])
    return int(ss.generate_state(1, np.uint32)[0])
