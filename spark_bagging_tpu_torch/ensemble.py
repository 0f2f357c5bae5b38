"""The ensemble engine: chunked replica fit and batched predict.

Every replica's bootstrap weights are drawn on the device from folded
keys (ops/bootstrap.py); the base learner fits a whole chunk of
replicas at once along a leading replica axis, and the chunks run one
after another (``chunk_size``, the JAX package's ``lax.map`` batch),
which bounds peak memory at ``chunk_size`` × the per-replica working
set. Prediction is one batched forward per chunk plus a mean or vote
over replicas.

With the identity feature subspace, X stays one shared tensor that no
replica copies; so it does, in the fit and in prediction, for a learner
that reads its subspace through the column index
(``reads_subspace_index``, the trees). Any other learner takes each
chunk's gathered columns.

Sharding hooks, as in the JAX package: ``data_axis`` names the mesh
axis rows are sharded over (each shard draws its rows' weights from
``fold_in(key, shard)`` and the learners' row reductions sum over it),
``replica_axis`` the axis replicas are sharded over (the vote and mean
reductions sum over it). Both default to None for one device;
``parallel/sharded.py`` sets them inside ``shard_map`` bodies.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops.aggregate import (
    hard_vote_counts,
    mean_aggregate,
    soft_vote_proba,
)
from spark_bagging_tpu_torch.ops.bootstrap import (
    bootstrap_weights,
    feature_subspaces,
    fit_key,
    oob_mask,
)
from spark_bagging_tpu_torch.ops import soft_vote, tree_vote
from spark_bagging_tpu_torch.utils.debug import check_bootstrap_weights


def _gather_columns(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each replica's feature columns: ``(n, d)``, ``(R, k)`` -> ``(R, n, k)``."""
    return X[:, idx.long()].permute(1, 0, 2).contiguous()


def fit_ensemble(
    learner: BaseLearner,
    X: torch.Tensor,
    y: torch.Tensor,
    key: torch.Tensor,
    replica_ids: torch.Tensor,
    n_outputs: int,
    *,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_subspace: int | None = None,
    bootstrap_features: bool = False,
    chunk_size: int | None = None,
    row_mask: torch.Tensor | None = None,
    use_pooled_init: bool | None = None,
    aux: torch.Tensor | None = None,
    data_axis: str | None = None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, dict[str, torch.Tensor]]:
    """Fit all replicas in ``replica_ids``.

    Returns ``(stacked_params, subspaces, aux)``: every params leaf has
    a leading replica axis, ``subspaces`` is ``(R, n_subspace)`` int32
    and ``aux["loss"]`` the per-replica final losses.

    ``row_mask`` multiplies into every replica's weights; ``aux``
    ``(n,)`` is the per-row auxiliary column of a ``uses_aux`` learner,
    beside y (bagging reweights rows, so a drawn row keeps its flag).
    ``use_pooled_init`` overrides the learner's ``uses_pooled_init``
    (the estimator passes its amortization decision, keyed to the total
    ensemble size).

    With ``data_axis`` set (inside a data-sharded ``shard_map`` body),
    each shard draws its rows' weights from ``fold_in(key, shard)``
    while subspaces and fit keys stay shard-invariant, and the learner
    sums its row statistics over the axis: every replica's fit is the
    fit on all shards' rows. The realized bootstrap then depends on the
    mesh layout, as in the JAX package.
    """
    n_rows, n_features = X.shape
    if n_subspace is None:
        n_subspace = n_features
    identity_subspace = n_subspace == n_features and not bootstrap_features
    if use_pooled_init is None:
        use_pooled_init = learner.uses_pooled_init
    row_key = _row_key(key, data_axis)
    # the axis reaches the learner only when set, so a learner written
    # for one device keeps its plain signature
    axis_kw = {} if data_axis is None else {"axis_name": data_axis}
    # replica-invariant work runs once, outside the replica chunks: the
    # trees' bin edges and codes, the pooled start
    with telemetry.span("fit_prepare"):
        prepared = learner.prepare(X, row_mask=row_mask, **axis_kw)
        if use_pooled_init:
            prepared = learner.pooled_init(
                key, prepared, X, y, n_outputs, row_mask=row_mask, **axis_kw
            )

    def fit_chunk(rids):
        # a chunk's draws and subspaces, then the learner's fit of it
        with telemetry.span("replica_chunk", replicas=int(rids.shape[0])):
            w = bootstrap_weights(
                row_key, rids, n_rows, ratio=sample_ratio,
                replacement=bootstrap
            )
            check_bootstrap_weights(w)  # no-op unless debug_mode()
            if row_mask is not None:
                w = w * row_mask
            idx = feature_subspaces(
                key, rids, n_features, n_subspace,
                replacement=bootstrap_features
            )
            if identity_subspace:
                Xs, prep = X, prepared
            else:
                prep = learner.gather_subspace(prepared, idx)
                Xs = (X if learner.reads_subspace_index
                      else _gather_columns(X, idx))
            with telemetry.span("learner_fit"):
                params, fit_aux = learner.fit_from_init(
                    fit_key(key, rids), Xs, y, w, n_outputs, prepared=prep,
                    aux=aux, **axis_kw,
                )
            return params, idx, fit_aux["loss"]

    params, subspaces, losses = map_replicas(fit_chunk, replica_ids, chunk_size)
    return params, subspaces, {"loss": losses}


def _row_key(key: torch.Tensor, data_axis: str | None) -> torch.Tensor:
    """The key of the row draws: ``fold_in(key, shard)`` on a data
    shard, ``key`` itself otherwise."""
    if data_axis is None:
        return key
    from spark_bagging_tpu_torch.ops import prng
    from spark_bagging_tpu_torch.parallel.compat import axis_index

    return prng.fold_in(key, axis_index(data_axis))


def _score_chunk(learner, params, idx, X, identity_subspace):
    """One chunk's per-replica scores. A learner that reads its subspace
    through the column index (the trees) scores the shared X with
    ``cols=idx``; any other takes each replica's gathered columns."""
    if identity_subspace:
        return learner.predict_scores(params, X)
    if learner.reads_subspace_index:
        return learner.predict_scores(params, X, cols=idx)
    return learner.predict_scores(params, _gather_columns(X, idx))


def predict_scores_ensemble(
    learner: BaseLearner,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    X: torch.Tensor,
    *,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> torch.Tensor:
    """Per-replica scores ``(R, n, C)``."""
    def one(chunk):
        params, idx = chunk
        return _score_chunk(learner, params, idx, X, identity_subspace)

    return map_replicas(one, (stacked_params, subspaces), chunk_size)


def predict_quantiles_ensemble(
    learner: BaseLearner,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    X: torch.Tensor,
    probs: tuple[float, ...],
    *,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> torch.Tensor:
    """The mean over replicas of a survival learner's quantiles ``(n,
    len(probs))``, each chunk summed as it is computed."""

    def one(chunk):
        params, idx = chunk
        Xs = X if identity_subspace else _gather_columns(X, idx)
        return learner.predict_quantiles(params, Xs, probs).sum(dim=0)

    chunk_sums = torch.stack(
        _chunks_apply(one, (stacked_params, subspaces), chunk_size)
    )
    return mean_aggregate(chunk_sums, n_total=_leading_size(subspaces))


def kernel_vote(
    learner: BaseLearner,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    X: torch.Tensor,
    n_classes: int,
    n_total: int,
    *,
    voting: str,
    identity_subspace: bool,
) -> tuple[torch.Tensor, Callable] | None:
    """The vote over every replica of ``stacked_params`` through a
    hand-written kernel: ``(sums, finish)``, the kernel's exact sums and
    the step that turns stacked parts' sums into the mean probabilities
    (``finish(parts, n_total=, axis_name=)``); None where the torch chain
    runs. The one place the forwards (the batch and serving closure, a
    mesh shard's, a replica-sharded server's) take a vote kernel.

    A learner declares the form of its scores, and the kernel's module
    says which inputs it takes (``kernel_applies``): a soft vote of
    ``augment_bias(X) @ W`` (``linear_softmax_weights``) on the identity
    subspace takes ops/soft_vote.py's fixed-point sums and
    ``soft_vote_mean``; a hard vote of trees (``tree_leaf_scores``) takes
    ops/tree_vote.py's whole-number counts and ``mean_aggregate``."""
    if (voting == "soft" and identity_subspace
            and learner.linear_softmax_weights is not None):
        W = stacked_params[learner.linear_softmax_weights]
        if soft_vote.kernel_applies(X, W, n_classes, n_total):
            return soft_vote.soft_vote_quanta(X, W), soft_vote.soft_vote_mean
    if voting == "hard" and learner.tree_leaf_scores is not None:
        p = stacked_params
        if tree_vote.kernel_applies(X, p["threshold"], learner.max_depth,
                                    n_classes, n_total):
            counts = tree_vote.tree_vote_counts(
                X, p["feature"], p["threshold"], p[learner.tree_leaf_scores],
                depth=learner.max_depth, n_classes=n_classes,
                cols=None if identity_subspace else subspaces)
            return counts, mean_aggregate
    return None


def predict_ensemble_classifier(
    learner: BaseLearner,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    X: torch.Tensor,
    n_classes: int,
    n_total: int,
    *,
    voting: str = "soft",
    replica_axis: str | None = None,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> torch.Tensor:
    """Aggregated class probabilities ``(n, C)``: the mean softmax
    probability (``voting="soft"``) or the vote frequencies
    (``"hard"``). Each chunk is reduced over its replicas as it is
    scored, so the ``(R, n, C)`` scores of the whole ensemble never
    exist at once; the chunk sums are then averaged over all replicas
    (summed over ``replica_axis``'s shards first, where it is set).

    Where a kernel takes the vote (:func:`kernel_vote`), the sum over
    every replica is one launch: it keeps no ``(R, n, C)`` scores, so no
    replica chunk bounds its memory, and its sums are exact, so they
    have the same bits as chunk by chunk, or shard by shard on a mesh."""
    if voting not in ("soft", "hard"):
        raise ValueError(f"unknown voting {voting!r}")
    voted = kernel_vote(learner, stacked_params, subspaces, X, n_classes,
                        n_total, voting=voting,
                        identity_subspace=identity_subspace)
    if voted is not None:
        sums, finish = voted
        return finish(sums[None], n_total=n_total, axis_name=replica_axis)

    def one(chunk):
        params, idx = chunk
        scores = _score_chunk(learner, params, idx, X, identity_subspace)
        if voting == "soft":
            return torch.softmax(scores, dim=-1).sum(dim=0)
        return hard_vote_counts(scores.argmax(dim=-1), n_classes)

    chunk_sums = torch.stack(
        _chunks_apply(one, (stacked_params, subspaces), chunk_size)
    )
    if voting == "soft":
        return soft_vote_proba(chunk_sums, n_total=n_total,
                               axis_name=replica_axis)
    return mean_aggregate(chunk_sums, n_total=n_total,
                          axis_name=replica_axis)


def predict_ensemble_regressor(
    learner: BaseLearner,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    X: torch.Tensor,
    n_total: int,
    *,
    replica_axis: str | None = None,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> torch.Tensor:
    """Mean prediction over replicas ``(n,)``: each chunk summed over its
    replicas as it is scored, the chunk sums then divided by the replica
    count."""

    def one(chunk):
        params, idx = chunk
        return _score_chunk(learner, params, idx, X, identity_subspace).sum(0)

    chunk_sums = torch.stack(
        _chunks_apply(one, (stacked_params, subspaces), chunk_size)
    )
    return mean_aggregate(chunk_sums, n_total=n_total,
                          axis_name=replica_axis)


def classifier_forward(
    learner: BaseLearner,
    n_classes: int,
    n_total: int,
    *,
    voting: str = "soft",
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> Callable:
    """The aggregated classifier forward as one closure
    ``forward(stacked_params, subspaces, X) -> (n, C) proba``."""

    def forward(stacked_params, subspaces, X):
        return predict_ensemble_classifier(
            learner, stacked_params, subspaces, X, n_classes, n_total,
            voting=voting, chunk_size=chunk_size,
            identity_subspace=identity_subspace,
        )

    return forward


def regressor_forward(
    learner: BaseLearner,
    n_total: int,
    *,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> Callable:
    """The aggregated regressor forward as one closure
    ``forward(stacked_params, subspaces, X) -> (n,) predictions``."""

    def forward(stacked_params, subspaces, X):
        return predict_ensemble_regressor(
            learner, stacked_params, subspaces, X, n_total,
            chunk_size=chunk_size, identity_subspace=identity_subspace,
        )

    return forward


def classifier_replica_forward(
    learner: BaseLearner,
    n_classes: int,
    *,
    voting: str = "soft",
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> Callable:
    """The per-replica classifier forward ``forward(stacked_params,
    subspaces, X) -> (R, n, C)``: :func:`classifier_forward` without the
    aggregation. Each replica gives what the aggregate averages (softmax
    probabilities for soft voting, the one-hot of its argmax for hard
    voting), so the mean over replicas is the served probability."""
    if voting not in ("soft", "hard"):
        raise ValueError(f"unknown voting {voting!r}")

    def forward(stacked_params, subspaces, X):
        scores = predict_scores_ensemble(
            learner, stacked_params, subspaces, X,
            chunk_size=chunk_size, identity_subspace=identity_subspace,
        )
        if voting == "hard":
            return torch.nn.functional.one_hot(
                scores.argmax(dim=-1), n_classes
            ).to(torch.float32)
        return torch.softmax(scores, dim=-1)

    return forward


def regressor_replica_forward(
    learner: BaseLearner,
    *,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> Callable:
    """The per-replica regressor forward ``forward(stacked_params,
    subspaces, X) -> (R, n)``: :func:`regressor_forward` without the
    mean."""

    def forward(stacked_params, subspaces, X):
        return predict_scores_ensemble(
            learner, stacked_params, subspaces, X,
            chunk_size=chunk_size, identity_subspace=identity_subspace,
        )

    return forward


def oob_predict_scores(
    learner: BaseLearner,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    X: torch.Tensor,
    key: torch.Tensor,
    replica_ids: torch.Tensor,
    *,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_classes: int | None = None,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
    data_axis: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Out-of-bag aggregation: each replica votes only on the rows its
    regenerated bootstrap weights leave at zero. Returns ``(agg,
    n_votes)``: OOB vote counts ``(n, C)`` for classification (the
    masked prediction sum ``(n,)`` for regression) and the per-row
    count of OOB replicas. ``data_axis``: the fit was data-sharded, and
    this shard replays its ``fold_in(key, shard)`` draws."""
    row_key = _row_key(key, data_axis)

    def one(chunk):
        params, idx, rids = chunk
        contrib, votes = oob_replica_contrib(
            learner, params, idx, rids, X, row_key,
            sample_ratio=sample_ratio, bootstrap=bootstrap,
            n_classes=n_classes, identity_subspace=identity_subspace,
        )
        return contrib.sum(dim=0), votes.sum(dim=0)

    parts = _chunks_apply(
        one, (stacked_params, subspaces, replica_ids), chunk_size
    )
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def oob_replica_contrib(
    learner: BaseLearner,
    params: dict[str, torch.Tensor],
    idx: torch.Tensor,
    rids: torch.Tensor,
    X: torch.Tensor,
    weight_key: torch.Tensor,
    *,
    sample_ratio: float,
    bootstrap: bool,
    n_classes: int | None,
    identity_subspace: bool,
    extra_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A replica chunk's OOB votes ``(R, n, C)`` (one-hot argmax; the
    masked predictions ``(R, n)`` for regression) and masks ``(R, n)``.
    ``extra_mask`` ``(n,)`` ANDs in row validity (a stream chunk's
    padding)."""
    w = bootstrap_weights(
        weight_key, rids, X.shape[0], ratio=sample_ratio,
        replacement=bootstrap,
    )
    mask = oob_mask(w).to(torch.float32)
    if extra_mask is not None:
        mask = mask * extra_mask
    scores = _score_chunk(learner, params, idx, X, identity_subspace)
    if n_classes is not None:
        onehot = torch.nn.functional.one_hot(
            scores.argmax(dim=-1), n_classes
        ).to(torch.float32)
        return onehot * mask[..., None], mask
    return scores * mask, mask


def _slice_tree(tree: Any, sl: slice) -> Any:
    if isinstance(tree, dict):
        return {k: _slice_tree(v, sl) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slice_tree(v, sl) for v in tree)
    return tree[sl]


def _cat_tree(parts: list) -> Any:
    first = parts[0]
    if isinstance(first, dict):
        return {k: _cat_tree([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(_cat_tree([p[i] for p in parts])
                     for i in range(len(first)))
    return first if len(parts) == 1 else torch.cat(parts, dim=0)


def _leading_size(tree: Any) -> int:
    while isinstance(tree, (dict, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def _chunks_apply(fn, args, chunk_size: int | None) -> list:
    """``fn`` on consecutive replica chunks of ``args`` (dicts and
    tuples of tensors with a leading replica axis)."""
    n = _leading_size(args)
    step = n if chunk_size is None else max(1, int(chunk_size))
    return [fn(_slice_tree(args, slice(s, s + step)))
            for s in range(0, max(n, 1), step)]


def map_replicas(fn, args, chunk_size: int | None):
    """``fn`` over replica chunks of ``args``, outputs concatenated along
    the replica axis: all replicas at once (``chunk_size=None``) or
    ``chunk_size`` at a time, to bound the memory in flight."""
    return _cat_tree(_chunks_apply(fn, args, chunk_size))
