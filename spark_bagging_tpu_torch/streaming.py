"""Out-of-core ensemble training over chunked data streams.

The port of the JAX package's ``streaming.py``: host chunks
(utils/io.py) are copied to the device one at a time, and every
replica takes ``steps_per_chunk`` Adam steps (optim.py, optax's
arithmetic) on each, its bootstrap weights regenerated on the device
from ``(seed, chunk_id, replica_id)``.

Why this is exact bagging: the Poisson bootstrap factorizes over rows,
so a replica's weight for row j depends only on its key. Keying the
draw by the chunk's id makes weights *epoch-stable*: revisiting chunk c
in a later epoch regenerates exactly its weights, so the stream fit
optimizes one fixed weighted objective, chunk by chunk. Each chunk's
weights are bitwise the JAX package's
(``bootstrap_weights(fold_in(fold_in(key, 0xC4C), c), ids, ...)``),
times the chunk's validity mask, so a padded tail row weighs 0.

The ensemble's parameters and Adam moments stay on the device, updated
in place; only the chunk crosses from the host, pinned and
asynchronously, so the host makes and sends chunk c+1 while the device
steps on chunk c. The losses stay on the device too: the one wait is
the first step's, which times it.

``aux_col`` names one streamed column as the per-row aux channel of a
``uses_aux`` learner (the survival learner's censor flags, Spark's
censorCol as a column): each chunk splits it off on the host
(:func:`split_aux_col`, shared by the fit and the OOB pass), so every
chunk source carries aux with no change of format.

Not ported yet: checkpoints and resume, and ``mesh`` (the estimators
raise naming the ROADMAP item).
"""

from __future__ import annotations

import time
from contextlib import closing
from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch.ensemble import (
    _chunks_apply,
    _gather_columns,
    oob_replica_contrib,
)
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import (
    bootstrap_weights,
    feature_subspaces,
    replica_init_fit_keys,
)
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.optim import Adam
from spark_bagging_tpu_torch.utils.device import synchronize
from spark_bagging_tpu_torch.utils.io import ChunkSource

_EPS = 1e-8
# the chunk-keyed row draws' stream tag: the JAX package's, distinct
# from ops/bootstrap.py's so streamed and in-memory draws never collide
_CHUNK_STREAM = 0xC4C


def split_aux_col(Xc, aux_col: int | None
                  ) -> tuple[np.ndarray, np.ndarray | None]:
    """``(X without the aux column, the aux column or None)`` of a host
    chunk, both float32: the one place the column's convention lives,
    shared by the fit and the OOB pass."""
    Xc = np.asarray(Xc, np.float32)
    if aux_col is None:
        return Xc, None
    return np.delete(Xc, aux_col % Xc.shape[1], axis=1), Xc[:, aux_col]


def learner_fingerprint(learner: BaseLearner) -> str:
    """The learner's hyperparameters as one stable string, the JAX
    package's format (which keys its stream checkpoints and warm-start
    guard on it)."""
    key = sorted((k, repr(v))
                 for k, v in learner.get_params(deep=False).items())
    return repr(key) + type(learner).__qualname__


def to_device(a: np.ndarray, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """A host chunk on ``device``: on the card through pinned memory and
    an asynchronous copy, since a copy from pageable memory waits for
    the device's queue and would stop the host from running ahead."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def chunk_context(row_key: torch.Tensor, chunk_id: int, n_valid: int,
                  chunk_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(validity mask (chunk_rows,) float32, weight key)`` of one chunk:
    the key every replica's weights of that chunk are drawn from."""
    valid = (torch.arange(chunk_rows, device=row_key.device)
             < n_valid).to(torch.float32)
    return valid, prng.fold_in(row_key, chunk_id)


def _loss_and_grad(learner, params, X, y, w, denom, aux=None):
    """Each replica's weighted mean row loss plus its penalty ``(R,)``,
    and the gradient of their sum: replicas share no parameters, so it
    is every replica's own gradient. ``aux``: the chunk's aux column,
    for a ``uses_aux`` learner."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    kw = {"aux": aux} if learner.uses_aux else {}
    with torch.enable_grad(), fp32_matmul():
        loss = ((w * learner.row_loss(p, X, y, **kw)).sum(dim=-1) / denom
                + learner.penalty(p))
        grads = torch.autograd.grad(loss.sum(), list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def fit_ensemble_stream(
    learner: BaseLearner,
    source: ChunkSource,
    key: torch.Tensor,
    n_replicas: int,
    n_outputs: int,
    *,
    n_epochs: int = 1,
    steps_per_chunk: int = 1,
    lr: float = 0.01,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_subspace: int | None = None,
    bootstrap_features: bool = False,
    aux_col: int | None = None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, dict[str, Any]]:
    """Fit all replicas by streaming chunks from ``source`` on the
    device ``key`` lies on.

    Returns ``(stacked_params, subspaces, aux)`` as ``fit_ensemble``
    does, so the fitted ensemble predicts like an in-memory fit.
    ``aux["loss"]`` is each replica's mean loss over the last epoch's
    chunks; ``aux["first_step_seconds"]`` the first chunk's time.
    ``aux_col``: the streamed column that is a ``uses_aux`` learner's aux
    channel (split off every chunk); the model's features are the others.
    """
    if not learner.streamable:
        raise TypeError(
            f"{type(learner).__name__} does not support streaming fits "
            "(no row_loss/penalty); use an SGD-capable learner or the "
            "in-memory fit"
        )
    if aux_col is not None and not learner.uses_aux:
        raise ValueError(
            f"aux_col was passed but {type(learner).__name__} does "
            "not declare uses_aux (the column would be silently "
            "dropped)"
        )
    n_features = source.n_features - (1 if aux_col is not None else 0)
    if aux_col is not None:
        if not -source.n_features <= aux_col < source.n_features:
            raise ValueError(
                f"aux_col={aux_col} out of range for "
                f"{source.n_features} streamed columns"
            )
        aux_col = aux_col % source.n_features
    elif learner.uses_aux:
        import warnings

        warnings.warn(
            f"{type(learner).__name__} consumes a per-row aux column "
            "but the stream carries none (aux_col=None): every row is "
            "treated as fully observed. If the censor indicator is a "
            "column of the stream, pass aux_col=<index> - otherwise it "
            "is being fit as an ordinary feature.", UserWarning,
        )
    device = key.device
    chunk_rows = source.chunk_rows
    if n_subspace is None:
        n_subspace = n_features
    identity_subspace = n_subspace == n_features and not bootstrap_features
    ids = torch.arange(n_replicas, dtype=torch.int64, device=device)
    subspaces = feature_subspaces(
        key, ids, n_features, n_subspace, replacement=bootstrap_features
    )
    row_key = prng.fold_in(key, _CHUNK_STREAM)
    init_keys, _ = replica_init_fit_keys(key, ids)
    params = learner.init_params(init_keys, n_subspace, n_outputs)
    opt = Adam(params, lr)
    y_dtype = (torch.int64 if learner.task == "classification"
               else torch.float32)

    n_chunks = source.n_chunks
    t0 = time.perf_counter()
    first_step_seconds = None
    final_epoch_losses: list[torch.Tensor] = []
    steps_done = 0
    for epoch in range(n_epochs):
        seen = 0
        with closing(source.chunks()) as chunk_iter:
            for c, (Xc, yc, n_valid) in enumerate(chunk_iter):
                seen = c + 1
                Xc, auxc = split_aux_col(Xc, aux_col)
                Xd = to_device(Xc, device, torch.float32)
                yd = to_device(np.asarray(yc), device, y_dtype)
                auxd = (None if auxc is None
                        else to_device(auxc, device, torch.float32))
                valid, chunk_key = chunk_context(row_key, c, n_valid,
                                                 chunk_rows)
                # fixed for the visit: the objective doesn't change
                # across its steps
                w = bootstrap_weights(
                    chunk_key, ids, chunk_rows, ratio=sample_ratio,
                    replacement=bootstrap,
                ) * valid
                denom = torch.clamp_min(w.sum(dim=-1), _EPS)
                Xs = Xd if identity_subspace else _gather_columns(
                    Xd, subspaces)
                for _ in range(steps_per_chunk):
                    loss, grads = _loss_and_grad(learner, params, Xs, yd,
                                                 w, denom, auxd)
                    opt.step(params, grads)
                if first_step_seconds is None:
                    synchronize(device)
                    first_step_seconds = time.perf_counter() - t0
                if epoch == n_epochs - 1:
                    final_epoch_losses.append(loss)
                steps_done += 1
        # a source that yields another count than it declares would
        # visit chunks under the wrong ids on a later epoch
        if seen != n_chunks:
            raise ValueError(
                f"source yielded {seen} chunk(s) for an epoch; it "
                f"declares n_chunks={n_chunks} (n_rows={source.n_rows}, "
                f"chunk_rows={chunk_rows})"
            )
    if not final_epoch_losses:
        raise ValueError("source yielded no chunks")
    aux = {
        # per-replica mean over the final epoch's chunks (reporting only)
        "loss": torch.stack(final_epoch_losses).mean(dim=0),
        "n_chunks": n_chunks,
        "n_epochs": n_epochs,
        "stream_seconds": time.perf_counter() - t0,
        "first_step_seconds": first_step_seconds,
        "opt_steps": steps_done * steps_per_chunk,
        "chunk_rows": chunk_rows,
    }
    return params, subspaces, aux


def oob_scores_stream(
    learner: BaseLearner,
    source: ChunkSource,
    key: torch.Tensor,
    stacked_params: dict[str, torch.Tensor],
    subspaces: torch.Tensor,
    n_replicas: int,
    *,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_classes: int | None = None,
    chunk_size: int | None = None,
    identity_subspace: bool = False,
    aux_col: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OOB aggregation of a streamed fit: one more pass over the
    source, the fit's ``aux_col`` (if any) dropped from every chunk. Both stream engines draw chunk c's weights from
    ``fold_in(fold_in(key, 0xC4C), c)``, so regenerating them replays
    each replica's membership, and its ``w == 0`` rows of the chunk are
    its out-of-bag rows.

    Returns ``(agg, n_votes, y)`` over all valid rows in stream order:
    vote counts ``(n, C)`` (prediction sums ``(n,)`` for regression);
    rows with no vote have no OOB estimate.
    """
    device = key.device
    row_key = prng.fold_in(key, _CHUNK_STREAM)
    chunk_rows = source.chunk_rows
    ids = torch.arange(n_replicas, dtype=torch.int64, device=device)
    aggs, votes_all, ys = [], [], []
    with closing(source.chunks()) as chunk_iter:
        for c, (Xc, yc, n_valid) in enumerate(chunk_iter):
            Xc, _ = split_aux_col(Xc, aux_col)
            Xd = to_device(Xc, device, torch.float32)
            valid, chunk_key = chunk_context(row_key, c, n_valid,
                                             chunk_rows)

            def one(chunk, Xd=Xd, valid=valid, chunk_key=chunk_key):
                params, idx, rids = chunk
                contrib, votes = oob_replica_contrib(
                    learner, params, idx, rids, Xd, chunk_key,
                    sample_ratio=sample_ratio, bootstrap=bootstrap,
                    n_classes=n_classes, identity_subspace=identity_subspace,
                    extra_mask=valid,
                )
                return contrib.sum(dim=0), votes.sum(dim=0)

            parts = _chunks_apply(one, (stacked_params, subspaces, ids),
                                  chunk_size)
            aggs.append(sum(p[0] for p in parts).cpu().numpy()[:n_valid])
            votes_all.append(sum(p[1] for p in parts).cpu().numpy()[:n_valid])
            ys.append(np.asarray(yc)[:n_valid])
    return (
        np.concatenate(aggs),
        np.concatenate(votes_all),
        np.concatenate(ys),
    )
