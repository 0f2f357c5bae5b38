"""Dataset registry, file parsers and deterministic synthetics (numpy).

A copy of the JAX package's ``utils/datasets.py``: the libsvm and CSV
parsers (``parse_libsvm``, ``load_csv``: the g++-built host loader,
``utils/host_native.py``, where it builds, else the pure-Python
parsers, which give the same arrays), ``make_classification``,
``make_regression``, ``synthetic_covtype``, ``synthetic_higgs``,
``synthetic_criteo`` and ``synthetic_california``, and the
``load_dataset`` registry over sklearn's bundled datasets (sklearn is
imported only when one is loaded), local files and the synthetics;
and of the benchmark configurations' ``standardize`` and
``train_test_split`` (``benchmarks/run_configs.py``). Both packages
must produce bitwise the same arrays from the same seed: the parity
tests and the headline workload feed identical data to each.
``SYNTHETICS_VERSION`` is bumped together with the JAX package's.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

SYNTHETICS_VERSION = "v4"

# ---------------------------------------------------------------------
# File parsers
# ---------------------------------------------------------------------


def parse_libsvm(
    path: str, n_features: int | None = None, zero_based: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Parse a (dense-ified) libsvm file: ``label idx:val idx:val ...``.

    Uses the native C++ parser (utils/host_native.py) when available;
    the pure-Python path below is the portable fallback.
    """
    from spark_bagging_tpu_torch.utils.host_native import (
        note_served,
        parse_libsvm_native,
    )

    native = parse_libsvm_native(path, n_features, zero_based)
    if native is not None:
        note_served("native")
        return native
    note_served("python")
    labels: list[float] = []
    rows: list[dict[int, float]] = []
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            entries: dict[int, float] = {}
            for item in parts[1:]:
                idx_s, val_s = item.split(":", 1)
                try:
                    idx = int(idx_s) - (0 if zero_based else 1)
                except ValueError:
                    raise ValueError(
                        f"unsupported libsvm token {item!r} (ranking "
                        "extensions like 'qid:' are not supported — "
                        "strip them before loading)"
                    ) from None
                if idx < 0:  # match native parser: drop invalid indices
                    continue
                entries[idx] = float(val_s)
                max_idx = max(max_idx, idx)
            rows.append(entries)
    d = n_features if n_features is not None else max_idx + 1
    X = np.zeros((len(rows), d), np.float32)
    for i, entries in enumerate(rows):
        for j, v in entries.items():
            if j < d:
                X[i, j] = v
    return X, np.asarray(labels, np.float32)


def load_csv(
    path: str, *, label_col: int = -1, skip_header: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Load a numeric CSV into (X, y); native C++ parser when
    available, numpy fallback otherwise."""
    from spark_bagging_tpu_torch.utils.host_native import (
        load_csv_native,
        note_served,
    )

    try:
        native = load_csv_native(
            path, label_col=label_col, skip_header=skip_header
        )
        if native is not None:
            note_served("native")
            return native
    except ValueError:
        # the native parser is strict; fall through to genfromtxt so
        # malformed fields behave identically (NaN) with or without a
        # toolchain
        pass
    note_served("python")
    # mirror the native parser: the header is the first NON-blank
    # line, and n_cols comes from the first data line — genfromtxt's
    # raw-line skip_header would otherwise consume a leading blank and
    # parse the real header into an all-NaN data row
    skip = 0
    n_cols = 0
    with open(path) as f:
        pending_header = skip_header
        for i, line in enumerate(f):
            if not line.strip():
                continue
            if pending_header:
                skip = i + 1
                pending_header = False
                continue
            n_cols = len(line.split(","))
            break
    if n_cols < 2:
        raise ValueError(
            f"CSV needs >= 2 columns (features + label), got {n_cols}"
        )
    data = np.genfromtxt(
        path, delimiter=",", skip_header=skip, dtype=np.float32,
    )
    if data.ndim == 1:
        # exactly one data row (a single-COLUMN file cannot reach here
        # — n_cols >= 2 was checked above)
        data = data[None, :]
    y = data[:, label_col]
    X = np.delete(data, label_col % data.shape[1], axis=1)
    return np.ascontiguousarray(X), y


# ---------------------------------------------------------------------
# Synthetic generators (deterministic in seed)
# ---------------------------------------------------------------------


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


def standardize(X: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance per column (float32), as the benchmark
    configurations of the JAX package prepare their data."""
    mu, sigma = X.mean(0), X.std(0) + 1e-8
    return ((X - mu) / sigma).astype(np.float32)


def train_test_split(X: np.ndarray, y: np.ndarray, test_frac: float = 0.2,
                     seed: int = 0):
    """``(X_train, y_train, X_test, y_test)``: the first ``test_frac`` of
    a seeded permutation is the test set, as the JAX package's benchmark
    configurations split (``benchmarks/run_configs._split``)."""
    idx = np.random.default_rng(seed).permutation(len(y))
    n_test = int(len(y) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return X[tr], y[tr], X[te], y[te]


def make_regression(
    n_rows: int,
    n_features: int,
    *,
    seed: int = 0,
    noise: float = 0.5,
    structure_seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Linear data with Gaussian noise: ``y = X beta + noise * e``, X and
    e standard normal, beta ~ N(0, 1). ``structure_seed`` fixes beta
    independently of ``seed``, as in :func:`make_classification`."""
    rng = np.random.default_rng(seed)
    srng = rng if structure_seed is None else np.random.default_rng(
        structure_seed
    )
    beta = srng.normal(0.0, 1.0, n_features).astype(np.float32)
    X = rng.standard_normal((n_rows, n_features), np.float32)
    y = X @ beta + noise * rng.standard_normal(n_rows).astype(np.float32)
    return X, y.astype(np.float32)


def synthetic_california(
    n_rows: int = 20_640, seed: int = 5, structure_seed: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """California-housing signature: 8 features, regression."""
    return make_regression(
        n_rows, 8, seed=seed, noise=0.7, structure_seed=structure_seed
    )


def synthetic_covtype(
    n_rows: int = 581_012, seed: int = 7, structure_seed: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """covtype-581k signature: 54 features, 7 classes, imbalanced."""
    return make_classification(
        n_rows, 54, 7, seed=seed, class_sep=0.2, class_imbalance=True,
        axis_features=4, axis_gap=0.35, structure_seed=structure_seed,
    )


def synthetic_higgs(
    n_rows: int = 11_000_000, seed: int = 11, structure_seed: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """HIGGS-11M signature: 28 features, binary."""
    return make_classification(
        n_rows, 28, 2, seed=seed, class_sep=0.6,
        structure_seed=structure_seed,
    )


def synthetic_criteo(
    n_rows: int = 1_000_000, n_features: int = 1024, seed: int = 13,
    structure_seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Criteo-shaped signature: wide hashed-categorical-style features,
    binary CTR labels. Dense stand-in at configurable width."""
    return make_classification(
        n_rows, n_features, 2, seed=seed, class_sep=0.25,
        class_imbalance=True, structure_seed=structure_seed,
    )


# ---------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------


def _sklearn_loader(name: str) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
    def load():
        from sklearn import datasets as skd

        X, y = getattr(skd, f"load_{name}")(return_X_y=True)
        return X.astype(np.float32), y

    return load


_REGISTRY: dict[str, Callable[..., tuple[np.ndarray, np.ndarray]]] = {
    # bundled with sklearn: available offline
    "breast_cancer": _sklearn_loader("breast_cancer"),
    "iris": _sklearn_loader("iris"),
    "diabetes": _sklearn_loader("diabetes"),
    "wine": _sklearn_loader("wine"),
    "digits": _sklearn_loader("digits"),
    # the baseline configurations' synthetic stand-ins
    "covtype_synth": synthetic_covtype,
    "higgs_synth": synthetic_higgs,
    "criteo_synth": synthetic_criteo,
    "california_synth": synthetic_california,
}


def load_dataset(name: str, **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """Load a dataset by registry name, or from a local ``.svm``/``.csv``
    path. Raises KeyError with the available names otherwise."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    if os.path.exists(name):
        if name.endswith((".svm", ".libsvm", ".txt")):
            return parse_libsvm(name, **kwargs)
        if name.endswith(".csv"):
            return load_csv(name, **kwargs)
        if name.endswith((".parquet", ".pq", ".feather", ".arrow", ".ipc")):
            from spark_bagging_tpu_torch.utils.arrow import load_arrow

            return load_arrow(name, **kwargs)
        raise ValueError(f"unknown file format: {name}")
    raise KeyError(
        f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}"
    )
