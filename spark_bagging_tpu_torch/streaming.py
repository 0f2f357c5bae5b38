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

Checkpoints: ``checkpoint_dir`` with ``checkpoint_every=N`` snapshots
``(params, Adam state, cursor, last epoch's losses)`` every N
chunk-steps, in the JAX package's format (``state.msgpack`` in flax's
msgpack layout, ``meta.json``), installed atomically
(:func:`save_snapshot`); ``resume_from`` restores one, the JAX
package's included, and replays the stream from its cursor. Chunk-keyed
draws do not depend on when a chunk is visited, so a resumed fit is bit
for bit the uninterrupted one. Not ported yet: ``mesh`` (the estimators
raise naming the ROADMAP item).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import closing
from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
)
from spark_bagging_tpu_torch.ensemble import (
    _chunks_apply,
    _gather_columns,
    oob_replica_contrib,
)
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import (
    RNG_SCHEMA,
    bootstrap_weights,
    feature_subspaces,
    replica_init_fit_keys,
)
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.optim import Adam
from spark_bagging_tpu_torch.utils.device import synchronize
from spark_bagging_tpu_torch.utils import msgpack
from spark_bagging_tpu_torch.utils.checkpoint import install, reap_stale_tmp
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


def check_resume_config(meta: dict, config: dict, path: str) -> None:
    """A resumed run must continue THIS fit: raise naming the mismatched
    keys if the snapshot's config fingerprint differs."""
    saved = meta.get("config", {})
    if saved != config:
        diff = {k for k in set(saved) | set(config)
                if saved.get(k) != config.get(k)}
        raise ValueError(
            f"checkpoint at {path} was written by a different fit "
            f"configuration (mismatched: {sorted(diff)})"
        )


def save_snapshot(path: str, tree: Any, meta: dict) -> None:
    """Atomically install a snapshot at ``path``: ``state.msgpack``
    (``tree``, a dict of numpy leaves, in flax's msgpack layout) and
    ``meta.json``, written to ``path.tmp.<pid>`` and renamed into place.
    The previous snapshot moves aside to ``path.old`` until the new one
    is installed, so a kill at any point leaves one valid snapshot
    (:func:`_load_stream_checkpoint` falls back to ``path.old``). One
    writer (this process) per ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    reap_stale_tmp(path, tmp)
    os.makedirs(tmp, exist_ok=True)
    with telemetry.span("checkpoint_save", metric="sbt_checkpoint_seconds"):
        payload = msgpack.serialize(tree)
        with open(os.path.join(tmp, "state.msgpack"), "wb") as f:
            f.write(payload)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    telemetry.inc("sbt_checkpoint_bytes_total", float(len(payload)),
                  labels={"kind": "stream", "op": "save"})
    install(tmp, path)


def _save_stream_checkpoint(path: str, params, opt: Adam,
                            host_losses: list[np.ndarray],
                            meta: dict) -> None:
    """Snapshot an SGD stream fit: the parameters, the Adam state as
    optax's state dict, and the last epoch's per-chunk losses so far
    (``host_losses``: the caller's host mirror, extended between
    snapshots)."""
    n_rep = next(iter(params.values())).shape[0]
    tree = {
        "params": {k: v.detach().cpu().numpy() for k, v in params.items()},
        "opt_state": adam_state_to_jax(opt, n_rep),
        "final_epoch_losses": (np.stack(host_losses) if host_losses
                               else np.zeros((0, 0), np.float32)),
    }
    save_snapshot(path, tree, meta)


def _load_stream_checkpoint(path: str) -> tuple[dict, dict]:
    """``(meta, state tree)`` of the snapshot at ``path``, or of
    ``path.old`` after a crash between the two renames."""
    if not os.path.isdir(path) and os.path.isdir(f"{path}.old"):
        path = f"{path}.old"
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        tree = msgpack.restore(f.read())
    return meta, tree


def key_data(key: torch.Tensor) -> list[int]:
    """The key as the config fingerprint stores it (JAX's
    ``key_data(key).tolist()``)."""
    return [int(w) for w in key.cpu().tolist()]


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
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume_from: str | None = None,
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

    ``checkpoint_dir`` with ``checkpoint_every=N`` snapshots the fit
    every N chunk-steps; ``resume_from`` restores a snapshot, whose
    config fingerprint must match this call, and goes on from its
    cursor.
    """
    if not learner.streamable:
        raise TypeError(
            f"{type(learner).__name__} does not support streaming fits "
            "(no row_loss/penalty); use an SGD-capable learner or the "
            "in-memory fit"
        )
    if checkpoint_dir is not None and checkpoint_every <= 0:
        raise ValueError(
            "checkpoint_dir is set but checkpoint_every is 0 \u2014 no "
            "snapshot would ever be written; pass checkpoint_every=N"
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

    # the config fingerprint: a resumed run must be continuing THIS fit
    # (the JAX package's fields, so either package resumes the other's)
    config = {
        "key": key_data(key),
        "n_replicas": n_replicas,
        "n_outputs": n_outputs,
        "n_epochs": n_epochs,
        "steps_per_chunk": steps_per_chunk,
        "lr": lr,
        "sample_ratio": sample_ratio,
        "bootstrap": bootstrap,
        "n_subspace": n_subspace,
        "bootstrap_features": bootstrap_features,
        "chunk_rows": chunk_rows,
        "n_features": n_features,
        "n_rows": source.n_rows,
        "n_chunks": source.n_chunks,
        "rng_schema": RNG_SCHEMA,
        "aux_col": aux_col,
        "learner": learner_fingerprint(learner),
    }
    start_epoch, start_chunk = 0, 0
    final_epoch_losses: list[torch.Tensor] = []
    # host mirror of final_epoch_losses, extended at snapshot time only
    host_losses: list[np.ndarray] = []
    if resume_from is not None:
        meta, tree = _load_stream_checkpoint(resume_from)
        saved_cfg = meta.setdefault("config", {})
        saved_cfg.setdefault("aux_col", None)
        if saved_cfg["aux_col"] is not None:
            saved_cfg["aux_col"] %= source.n_features
        saved_cfg.setdefault("n_rows", source.n_rows)
        saved_cfg.setdefault("n_chunks", source.n_chunks)
        check_resume_config(meta, config, resume_from)
        for name, leaf in tree["params"].items():
            params[name].copy_(torch.from_numpy(np.array(leaf)))
        adam_state_from_jax(opt, tree["opt_state"])
        start_epoch, start_chunk = meta["epoch"], meta["next_chunk"]
        host_losses = [np.asarray(l) for l in tree["final_epoch_losses"]]
        final_epoch_losses = [torch.as_tensor(np.array(l), device=device)
                              for l in host_losses]

    n_chunks = source.n_chunks
    t0 = time.perf_counter()
    first_step_seconds = None
    steps_done = 0
    for epoch in range(start_epoch, n_epochs):
        # a resume seeks straight to its cursor
        offset = start_chunk if epoch == start_epoch else 0
        seen = offset - 1
        with closing(source.chunks_from(offset)) as chunk_iter:
            for c, (Xc, yc, n_valid) in enumerate(chunk_iter, start=offset):
                seen = c
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
                if (checkpoint_dir is not None
                        and steps_done % checkpoint_every == 0):
                    nxt_epoch, nxt_chunk = epoch, c + 1
                    if nxt_chunk >= n_chunks:
                        nxt_epoch, nxt_chunk = epoch + 1, 0
                    host_losses.extend(
                        l.cpu().numpy()
                        for l in final_epoch_losses[len(host_losses):])
                    _save_stream_checkpoint(
                        checkpoint_dir, params, opt, host_losses,
                        {"config": config, "epoch": nxt_epoch,
                         "next_chunk": nxt_chunk, "steps_done": steps_done})
        # the declared n_chunks drives a resume's epoch rollover: a
        # source that yields another count would skip or revisit chunks
        if seen + 1 != n_chunks:
            raise ValueError(
                f"source yielded {seen + 1 - offset} chunk(s) for an "
                f"epoch spanning chunks [{offset}, {n_chunks}) \u2014 it "
                f"declares n_chunks={n_chunks} (n_rows={source.n_rows}, "
                f"chunk_rows={chunk_rows}); a miscounted source breaks "
                "checkpoint-resume exactness"
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
