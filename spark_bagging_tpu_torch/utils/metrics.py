"""Evaluation metrics (numpy, on the host).

A copy of ``accuracy``, ``rmse``, ``r2_score`` and ``mae`` from the JAX
package's ``utils/metrics.py``: the estimators' ``score`` and OOB
scores use them, and both packages must score the same predictions the
same way.
"""

from __future__ import annotations

import numpy as np


def _weights(sample_weight, n: int) -> np.ndarray:
    if sample_weight is None:
        return np.ones((n,), np.float64)
    w = np.asarray(sample_weight, np.float64).ravel()
    if w.shape != (n,):
        raise ValueError(f"sample_weight shape {w.shape} != ({n},)")
    if w.sum() <= 0:
        raise ValueError("sample_weight sums to zero")
    return w


def _check_same_length(y_true, y_pred) -> None:
    if len(y_true) != len(y_pred):
        raise ValueError(
            f"y_true has {len(y_true)} samples, y_pred {len(y_pred)}"
        )


def accuracy(y_true, y_pred, sample_weight=None) -> float:
    """(Weighted) share of equal labels."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    _check_same_length(y_true, y_pred)
    correct = (y_true == y_pred).astype(np.float64)
    w = _weights(sample_weight, len(correct))
    return float((correct * w).sum() / w.sum())


def rmse(y_true, y_pred) -> float:
    """Root mean squared error."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    _check_same_length(y_true, y_pred)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def r2_score(y_true, y_pred, sample_weight=None) -> float:
    """(Weighted) coefficient of determination. A constant target scores
    1.0 for perfect predictions and 0.0 otherwise (sklearn's
    convention)."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    _check_same_length(y_true, y_pred)
    w = _weights(sample_weight, len(y_true))
    mean = (w * y_true).sum() / w.sum()
    ss_res = float((w * (y_true - y_pred) ** 2).sum())
    ss_tot = float((w * (y_true - mean) ** 2).sum())
    if ss_tot > 0:
        return 1.0 - ss_res / ss_tot
    return 1.0 if ss_res == 0 else 0.0


def mae(y_true, y_pred) -> float:
    """Mean absolute error."""
    return float(np.mean(np.abs(
        np.asarray(y_true, np.float64).ravel()
        - np.asarray(y_pred, np.float64).ravel()
    )))
