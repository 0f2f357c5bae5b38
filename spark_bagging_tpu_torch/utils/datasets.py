"""Deterministic synthetic datasets (numpy only).

A copy of ``make_classification`` and ``synthetic_covtype`` from the JAX
package's ``utils/datasets.py``. Both packages must produce bitwise the
same arrays from the same seed: the parity tests and the headline
workload feed identical data to each. ``SYNTHETICS_VERSION`` is bumped
together with the JAX package's.
"""

from __future__ import annotations

import numpy as np

SYNTHETICS_VERSION = "v4"


def make_classification(
    n_rows: int,
    n_features: int,
    n_classes: int,
    *,
    seed: int = 0,
    class_sep: float = 1.2,
    class_imbalance: bool = False,
    structure_seed: int | None = None,
    axis_features: int = 0,
    axis_gap: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-mixture classification data: one random center per class,
    unit-variance clouds. ``class_sep`` controls difficulty.

    ``axis_features`` > 0 gives the first k features axis-aligned class
    structure: feature j's per-class centers become a random permutation
    of equally spaced levels ``(perm_j[c] - (C-1)/2) * axis_gap``.

    ``structure_seed`` fixes the mixture itself (centers, class priors)
    independently of ``seed``, which then only varies the sampled rows.
    """
    rng = np.random.default_rng(seed)
    srng = rng if structure_seed is None else np.random.default_rng(
        structure_seed
    )
    centers = srng.normal(0.0, class_sep, (n_classes, n_features)).astype(
        np.float32
    )
    for j in range(min(axis_features, n_features)):
        perm = srng.permutation(n_classes).astype(np.float32)
        centers[:, j] = (perm - (n_classes - 1) / 2.0) * axis_gap
    if class_imbalance:
        p = srng.dirichlet(np.full(n_classes, 2.0))
    else:
        p = np.full(n_classes, 1.0 / n_classes)
    y = rng.choice(n_classes, size=n_rows, p=p).astype(np.int32)
    X = rng.standard_normal((n_rows, n_features), np.float32)
    X += centers[y]
    return X, y


def synthetic_covtype(
    n_rows: int = 581_012, seed: int = 7, structure_seed: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """covtype-581k signature: 54 features, 7 classes, imbalanced."""
    return make_classification(
        n_rows, 54, 7, seed=seed, class_sep=0.2, class_imbalance=True,
        axis_features=4, axis_gap=0.35, structure_seed=structure_seed,
    )
