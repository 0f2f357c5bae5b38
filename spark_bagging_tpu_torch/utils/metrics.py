"""Evaluation metrics (numpy, on the host).

A copy of ``accuracy``, ``rmse``, ``r2_score``, ``mae``, ``roc_auc``,
``pr_auc`` and ``f1_score`` from the JAX package's ``utils/metrics.py``: the estimators'
``score`` and OOB scores use them, and both packages must score the
same predictions the same way.
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


def _check_binary_labels(y_true: np.ndarray) -> None:
    """The binary rank metrics take label 1 as positive and every other
    value as negative, so a {1, 2}-coded target would score inverted:
    only the common binary codings are accepted."""
    vals = np.unique(y_true)
    if not (np.isin(vals, (0, 1)).all() or np.isin(vals, (-1, 1)).all()
            or np.isin(vals, (False, True)).all()):
        raise ValueError(
            f"binary metric needs labels in {{0,1}} or {{-1,1}}, got "
            f"{vals[:5]}"
        )


def roc_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC AUC via the rank statistic (ties get their average
    rank). ``y_true`` is {0,1}, {-1,1} or bool with 1/True positive; any
    other coding raises. One sort, then each run of tied scores is
    averaged by run-boundary arithmetic: O(n log n)."""
    y_true = np.asarray(y_true).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    _check_binary_labels(y_true)
    n = len(scores)
    order = np.argsort(scores, kind="mergesort")
    s = scores[order]
    # start of each run of equal scores (NaN != NaN: NaNs are singletons)
    starts = np.flatnonzero(np.r_[True, s[1:] != s[:-1]])
    counts = np.diff(np.r_[starts, n])
    # the 1-based ranks of run k average starts[k] + (counts[k] + 1) / 2
    run_avg = starts + (counts + 1) / 2.0
    run_id = np.cumsum(np.r_[False, s[1:] != s[:-1]])
    ranks = np.empty(n, np.float64)
    ranks[order] = run_avg[run_id]
    pos = y_true == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


def pr_auc(y_true: np.ndarray, scores: np.ndarray) -> float:
    """Area under the precision-recall curve as average precision, the
    step integral sum_k (R_k - R_{k-1}) P_k over descending-score
    thresholds, ties counted as one threshold. Labels as in
    :func:`roc_auc`."""
    y_true = np.asarray(y_true).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    _check_binary_labels(y_true)
    n_pos = int((y_true == 1).sum())
    if n_pos == 0:
        return 0.0
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(y_true[order] == 1)
    fp = np.cumsum(y_true[order] != 1)
    # the last index of each run of tied scores is one operating point
    s = scores[order]
    boundary = np.r_[s[1:] != s[:-1], True]
    tp, fp = tp[boundary], fp[boundary]
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def f1_score(y_true, y_pred, average: str = "weighted") -> float:
    """Multiclass F1 (Spark MulticlassClassificationEvaluator
    metricName=f1 is the weighted variant)."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    classes = np.unique(np.concatenate([y_true, y_pred]))
    f1s, weights = [], []
    for c in classes:
        tp = float(((y_pred == c) & (y_true == c)).sum())
        fp = float(((y_pred == c) & (y_true != c)).sum())
        fn = float(((y_pred != c) & (y_true == c)).sum())
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
        weights.append(float((y_true == c).sum()))
    f1s = np.asarray(f1s)
    if average == "macro":
        return float(f1s.mean())
    if average == "weighted":
        w = np.asarray(weights)
        return float((f1s * w).sum() / max(w.sum(), 1.0))
    raise ValueError(f"average must be weighted|macro, got {average!r}")
