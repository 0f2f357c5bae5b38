"""Prediction aggregation: probability mean, vote tally, regression mean.

One batched reduction over the leading replica axis. Each aggregator
takes a chunk of per-replica predictions and the *global* replica
count, so chunked callers sum the results of their chunks.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.ops.reduce import maybe_psum


def mean_aggregate(
    preds: torch.Tensor, *, n_total: int, axis_name: str | None = None
) -> torch.Tensor:
    """Sum over the leading replica axis divided by the global replica
    count: ``(R_local, ...) -> (...)``."""
    return maybe_psum(preds.sum(dim=0), axis_name) / n_total


def soft_vote_proba(
    probs: torch.Tensor, *, n_total: int, axis_name: str | None = None
) -> torch.Tensor:
    """Soft vote: mean class probability, ``(R_local, n, C) -> (n, C)``."""
    return mean_aggregate(probs, n_total=n_total, axis_name=axis_name)


def hard_vote_counts(
    pred_labels: torch.Tensor, n_classes: int, *,
    axis_name: str | None = None,
) -> torch.Tensor:
    """Majority-vote tally: ``(R_local, n) int -> (n, C) float``. The
    argmax of the tally breaks ties toward the lower class index."""
    onehot = torch.nn.functional.one_hot(
        pred_labels.long(), n_classes
    ).to(torch.float32)
    return maybe_psum(onehot.sum(dim=0), axis_name)
