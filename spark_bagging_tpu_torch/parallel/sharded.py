"""Ensemble fit, predict and OOB over a ``(data, replica)`` mesh.

The port of the JAX package's ``parallel/sharded.py``, over the
in-process ``shard_map`` of ``parallel/compat.py``. The sharding plan:

- ``X`` -> ``P(data, None)``: rows split over the data axis, every
  replica shard of a data row holds the same rows;
- ``y`` and the row mask -> ``P(data)``;
- replica ids -> ``P(replica)``: each replica shard fits its slice of
  the ensemble with the single-device engine;
- fitted params, subspaces and losses -> ``P(replica)`` on the leading
  (replica) axis;
- predictions -> ``P(data)``: the vote and mean reductions sum over
  the replica axis, row shards stay put.

Inside the shards the single-device engine runs unchanged: learners sum
their row statistics over ``data`` (every replica's fit is the fit on
all rows), the aggregation sums over ``replica``. Every learner family
takes the data axis, so any family fits on a replica, a data or a 2-D
mesh.

Divisibility: callers pad rows (``pad_rows``: padded rows carry zero
weight) and choose ``n_estimators`` divisible by the replica-axis size;
both are checked here.

On a mesh that spans processes the inputs may be ``global_put``
placements (``parallel/multihost.py``) and the outputs are this
process's shards (``compat.LocalShards``), which the caller gathers
with ``multihost.to_host``.

Serving shards the replica axis only (:func:`replica_sharded_serving`):
each shard forwards its replicas, the per-replica outputs are gathered
in replica order and reduced by the same operations the single-device
forward runs, so the served bits are the single-device executor's. A
``psum`` of per-shard partial sums would regroup the float sum and
drift in the last bit. :func:`replica_subset_serving` is the degraded
quorum's forward over the surviving replicas.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.ensemble import (
    _slice_tree,
    fit_ensemble,
    kernel_vote,
    oob_predict_scores,
    predict_ensemble_classifier,
    predict_ensemble_regressor,
)
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops.aggregate import mean_aggregate
from spark_bagging_tpu_torch.ops.reduce import maybe_psum
from spark_bagging_tpu_torch.parallel.compat import P, shard_map
from spark_bagging_tpu_torch.parallel.mesh import DATA_AXIS, REPLICA_AXIS, Mesh

def _axis_sizes(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape.get(DATA_AXIS, 1), mesh.shape.get(REPLICA_AXIS, 1)


def _mesh_label(mesh: Mesh) -> str:
    return "x".join(map(str, mesh.devices.shape))


def _check_divisible(n_rows: int, n_replicas: int, mesh: Mesh) -> None:
    data, replica = _axis_sizes(mesh)
    if n_rows % data != 0:
        raise ValueError(
            f"{n_rows} rows not divisible by data-axis size {data}; pad "
            f"rows first (pad_rows)"
        )
    if n_replicas % replica != 0:
        raise ValueError(
            f"n_estimators={n_replicas} not divisible by replica-axis "
            f"size {replica}"
        )


def _xp(*arrays):
    """numpy for host arrays, torch otherwise: padding a host matrix
    must not bounce it through the device."""
    return np if all(isinstance(a, np.ndarray) for a in arrays) else torch


def _cat(xp, parts):
    return xp.concatenate(parts) if xp is np else torch.cat(parts)


def _zeros(xp, shape, like):
    if xp is np:
        return np.zeros(shape, like.dtype)
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def pad_rows_X(X, multiple: int):
    """Pad only X's rows to a multiple (the predict path; the caller
    slices the padded rows' outputs off)."""
    xp = _xp(X)
    rem = (-X.shape[0]) % multiple
    if rem == 0:
        return X
    return _cat(xp, [X, _zeros(xp, (rem, X.shape[1]), X)])


def pad_rows(X, y, multiple: int):
    """Pad rows to a multiple; returns ``(X, y, row_mask)`` with mask 0
    on padding, so padded rows carry zero sample weight everywhere."""
    xp = _xp(X, y)
    n = X.shape[0]
    rem = (-n) % multiple
    if xp is np:
        mask = np.ones((n,), np.float32)
    else:
        mask = torch.ones((n,), dtype=torch.float32, device=X.device)
    if rem == 0:
        return X, y, mask
    Xp = _cat(xp, [X, _zeros(xp, (rem, X.shape[1]), X)])
    yp = _cat(xp, [y, _zeros(xp, (rem,), y)])
    maskp = _cat(xp, [mask, _zeros(xp, (rem,), mask)])
    return Xp, yp, maskp


def _count_trace(kind: str, mesh: Mesh) -> None:
    # each call builds and runs its sharded program once: the count of
    # sharded program builds, labeled as the JAX package labels them
    telemetry.inc("sbt_shardmap_traces_total",
                  labels={"kind": kind, "mesh": _mesh_label(mesh)})


def sharded_fit(
    learner: BaseLearner,
    mesh: Mesh,
    X: torch.Tensor,
    y: torch.Tensor,
    row_mask: torch.Tensor,
    key: torch.Tensor,
    n_replicas: int,
    n_outputs: int,
    *,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_subspace: int | None = None,
    bootstrap_features: bool = False,
    chunk_size: int | None = None,
    id_offset: int = 0,
    aux: torch.Tensor | None = None,
    use_pooled_init: bool | None = None,
) -> tuple[Any, torch.Tensor, dict[str, torch.Tensor]]:
    """Ensemble fit over the mesh, with the contract of
    :func:`~spark_bagging_tpu_torch.ensemble.fit_ensemble`. The returned
    params, subspaces and losses keep their global replica axis, on the
    mesh's first device (this process's shards of them on a
    process-spanning mesh). ``id_offset`` shifts the replica ids (a warm
    start); ``aux`` shards over the data axis beside ``y``."""
    _check_divisible(X.shape[0], n_replicas, mesh)
    data_axis = DATA_AXIS if mesh.shape.get(DATA_AXIS, 1) > 1 else None
    _count_trace("fit", mesh)
    with_aux = aux is not None
    in_specs = [P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P(),
                P(REPLICA_AXIS)]
    if with_aux:
        in_specs.append(P(DATA_AXIS))

    def _fit(Xs, ys, mask, k, ids, *aux_s):
        params, subspaces, fit_aux = fit_ensemble(
            learner, Xs, ys, k, ids, n_outputs,
            sample_ratio=sample_ratio, bootstrap=bootstrap,
            n_subspace=n_subspace, bootstrap_features=bootstrap_features,
            chunk_size=chunk_size, row_mask=mask,
            use_pooled_init=use_pooled_init,
            aux=aux_s[0] if aux_s else None, data_axis=data_axis,
        )
        return params, subspaces, fit_aux["loss"]

    run = shard_map(_fit, mesh=mesh, in_specs=tuple(in_specs),
                    out_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS),
                               P(REPLICA_AXIS)), check_vma=False)
    ids = id_offset + torch.arange(n_replicas, dtype=torch.int64)
    args = (X, y, row_mask, key, ids) + ((aux,) if with_aux else ())
    params, subspaces, losses = run(*args)
    return params, subspaces, {"loss": losses}


def sharded_predict_classifier(
    learner: BaseLearner,
    mesh: Mesh,
    stacked_params: Any,
    subspaces: torch.Tensor,
    X: torch.Tensor,
    n_classes: int,
    n_total: int,
    *,
    voting: str = "soft",
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> torch.Tensor:
    """Aggregated probabilities ``(n, C)``: each shard scores its rows
    with its replicas, the vote sums over the replica axis."""
    _check_divisible(X.shape[0], n_total, mesh)
    replica_axis = (REPLICA_AXIS if mesh.shape.get(REPLICA_AXIS, 1) > 1
                    else None)
    _count_trace("predict_clf", mesh)

    def _predict(params, subs, Xs):
        return predict_ensemble_classifier(
            learner, params, subs, Xs, n_classes, n_total, voting=voting,
            replica_axis=replica_axis, chunk_size=chunk_size,
            identity_subspace=identity_subspace,
        )

    return shard_map(
        _predict, mesh=mesh,
        in_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS, None), check_vma=False,
    )(stacked_params, subspaces, X)


def sharded_predict_regressor(
    learner: BaseLearner,
    mesh: Mesh,
    stacked_params: Any,
    subspaces: torch.Tensor,
    X: torch.Tensor,
    n_total: int,
    *,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> torch.Tensor:
    """Mean predictions ``(n,)`` over the mesh."""
    _check_divisible(X.shape[0], n_total, mesh)
    replica_axis = (REPLICA_AXIS if mesh.shape.get(REPLICA_AXIS, 1) > 1
                    else None)
    _count_trace("predict_reg", mesh)

    def _predict(params, subs, Xs):
        return predict_ensemble_regressor(
            learner, params, subs, Xs, n_total, replica_axis=replica_axis,
            chunk_size=chunk_size, identity_subspace=identity_subspace,
        )

    return shard_map(
        _predict, mesh=mesh,
        in_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS), P(DATA_AXIS, None)),
        out_specs=P(DATA_AXIS), check_vma=False,
    )(stacked_params, subspaces, X)


def sharded_oob_scores(
    learner: BaseLearner,
    mesh: Mesh,
    stacked_params: Any,
    subspaces: torch.Tensor,
    X: torch.Tensor,
    key: torch.Tensor,
    n_replicas: int,
    *,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_classes: int | None = None,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """OOB aggregation over the mesh. Each shard regenerates its rows'
    weights from the ``fold_in(key, data shard)`` stream the sharded fit
    drew from, so the out-of-bag masks are the fit's; the contributions
    and vote counts then sum over the replica axis. ``X`` must be padded
    as at fit time; the padded rows' outputs are the caller's to drop."""
    _check_divisible(X.shape[0], n_replicas, mesh)
    data_axis = DATA_AXIS if mesh.shape.get(DATA_AXIS, 1) > 1 else None
    replica_axis = (REPLICA_AXIS if mesh.shape.get(REPLICA_AXIS, 1) > 1
                    else None)
    classification = n_classes is not None
    _count_trace("oob", mesh)

    def _oob(params, subs, Xs, k, ids):
        contrib, votes = oob_predict_scores(
            learner, params, subs, Xs, k, ids, sample_ratio=sample_ratio,
            bootstrap=bootstrap, n_classes=n_classes, chunk_size=chunk_size,
            identity_subspace=identity_subspace, data_axis=data_axis,
        )
        return (maybe_psum(contrib, replica_axis),
                maybe_psum(votes, replica_axis))

    run = shard_map(
        _oob, mesh=mesh,
        in_specs=(P(REPLICA_AXIS), P(REPLICA_AXIS), P(DATA_AXIS, None), P(),
                  P(REPLICA_AXIS)),
        out_specs=(P(DATA_AXIS, None) if classification else P(DATA_AXIS),
                   P(DATA_AXIS)),
        check_vma=False,
    )
    ids = torch.arange(n_replicas, dtype=torch.int64)
    return run(stacked_params, subspaces, X, key, ids)


# -- serving -------------------------------------------------------------


def aggregate_reduce(model: Any, n_total: int) -> Callable:
    """The reduction the single-device aggregated forward runs over
    per-replica outputs ``(R, n, ...)``: each replica chunk summed, the
    chunk sums summed and divided by ``n_total``. Applied to the
    gathered per-replica outputs of every shard, it gives the
    single-device forward's bits."""
    eff = getattr(model, "_eff_chunk", None)
    chunk = eff() if callable(eff) else None

    def reduce(full: torch.Tensor) -> torch.Tensor:
        n = full.shape[0]
        step = n if chunk is None else max(1, int(chunk))
        sums = torch.stack([full[s:s + step].sum(dim=0)
                            for s in range(0, max(n, 1), step)])
        return mean_aggregate(sums, n_total=n_total)

    return reduce


class ShardedForward:
    """A serving forward over replica shards: ``fn(shard_params,
    shard_subspaces, X)`` runs each shard's per-replica forward in shard
    order on its device, gathers the outputs on the first shard's
    device in replica order, and (``aggregate=True``) reduces them with
    :func:`aggregate_reduce`. ``rep_fn``, ``reduce`` and ``devices`` are
    the pieces the serving executor captures shard by shard."""

    def __init__(self, rep_fn: Callable, reduce: Callable | None,
                 devices: list[torch.device]):
        self.rep_fn = rep_fn
        self.reduce = reduce
        self.devices = devices

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        first = self.devices[0]
        return torch.cat([p.to(first) for p in parts], dim=0)

    def __call__(self, shard_params, shard_subspaces, X):
        parts = [self.rep_fn(p, s, X.to(dev))
                 for p, s, dev in zip(shard_params, shard_subspaces,
                                      self.devices)]
        full = self.gather(parts)
        return full if self.reduce is None else self.reduce(full)


def replica_sharded_serving(model: Any, mesh: Mesh):
    """The mesh-sharded serving forwards of a fitted estimator: the
    stacked params' replica axis split over the mesh's ``replica`` axis
    (each shard holds and forwards ``R / n_shards`` replicas on its
    device), the request ``X`` the same for every shard, the aggregate
    on the first shard's device.

    Returns ``(fwd, replica_fwd, params, subspaces, x_device,
    n_shards)``: ``fwd(params, subspaces, X)`` is the aggregated serving
    forward and ``replica_fwd`` its aggregation-free twin (both
    :class:`ShardedForward`); ``params`` / ``subspaces`` are the
    per-shard lists on their devices; ``x_device`` is where request
    buffers go first."""
    data, replica = _axis_sizes(mesh)
    if data != 1:
        raise ValueError(
            f"serving shards the replica axis only; need a mesh with "
            f"data-axis size 1, got {data}x{replica} (serving shards "
            "by ensemble members — rows of one request stay together)"
        )
    rep_fn, params, subspaces = model.replica_forward()
    n_replicas = int(subspaces.shape[0])
    n_total = int(getattr(model, "n_estimators_", 0) or n_replicas)
    if n_replicas % replica != 0:
        raise ValueError(
            f"n_estimators={n_replicas} not divisible by replica-axis "
            f"size {replica}; choose a mesh whose replica axis divides "
            "the ensemble"
        )
    per = n_replicas // replica
    devices = [mesh.device(0, j) for j in range(replica)]
    shard_params, shard_subs = [], []
    for j, dev in enumerate(devices):
        sl = slice(j * per, (j + 1) * per)
        shard_params.append(_to(_slice_tree(params, sl), dev))
        shard_subs.append(subspaces[sl].to(dev))
    shard_fn, reduce = rep_fn, aggregate_reduce(model, n_total)
    if getattr(model, "task", None) == "classification":
        # a shard whose vote a kernel takes (ensemble.kernel_vote, on the
        # shard's X) gives its replicas' exact sums, finished as on one
        # device; the shards of one call (or capture) decide alike
        learner, chain, finish = model._fitted_learner, reduce, [None]

        def shard_fn(p, s, X):
            voted = kernel_vote(
                learner, p, s, X, int(model.n_classes_), n_total,
                voting=model.voting,
                identity_subspace=model._identity_subspace)
            finish[0] = None if voted is None else voted[1]
            return rep_fn(p, s, X) if voted is None else voted[0][None]

        def reduce(full: torch.Tensor) -> torch.Tensor:
            if finish[0] is None:
                return chain(full)
            return finish[0](full, n_total=n_total)

    fwd = ShardedForward(shard_fn, reduce, devices)
    replica_fwd = ShardedForward(rep_fn, None, devices)
    return fwd, replica_fwd, shard_params, shard_subs, devices[0], replica


def _to(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def replica_subset_serving(model: Any, survivors):
    """The degraded quorum's forward: the aggregate over a subset of the
    replicas, single-device. Any subset of independently bootstrapped
    replicas is itself a bagged estimate of the same target, so losing a
    shard leaves a valid aggregate. ``fwd`` reduces the subset's
    per-replica outputs ``(R_surv, n, ...)`` with ``sum(0) / R_surv``,
    so a served degraded output is bitwise the subset aggregate
    recomputed offline the same way.

    Returns ``(fwd, replica_fwd, params, subspaces)``, the params and
    subspaces restricted to ``survivors`` (sorted replica indices)."""
    rep_fn, params, subspaces = model.replica_forward()
    surv = np.asarray(sorted(int(i) for i in survivors), dtype=np.int64)
    if surv.size == 0:
        raise ValueError("need at least one surviving replica")
    if surv[0] < 0 or surv[-1] >= subspaces.shape[0]:
        raise ValueError(
            f"survivor indices must be in [0, {subspaces.shape[0]}), "
            f"got {surv[0]}..{surv[-1]}"
        )
    n_surv = int(surv.size)
    idx = torch.as_tensor(surv, device=subspaces.device)
    params = _take_rows(params, idx)
    subspaces = subspaces.index_select(0, idx)

    def fwd(p, s, Xs):
        return rep_fn(p, s, Xs).sum(dim=0) / n_surv

    return fwd, rep_fn, params, subspaces


def _take_rows(tree: Any, idx: torch.Tensor) -> Any:
    if isinstance(tree, dict):
        return {k: _take_rows(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx.to(tree.device))
