"""Out-of-core decision-tree ensembles: multi-pass level-synchronous
growth over a chunk source.

The port of the JAX package's ``tree_stream.py``. Trees need structure
search, not gradient steps, so the stream is read ``max_depth + 2``
times:

- **pass 0 (edges):** each chunk's quantile edges over its valid rows,
  averaged over the chunks that have any: one global binning;
- **passes 1..d (levels):** every replica regenerates each chunk's
  bootstrap weights from ``(seed, chunk_id, replica_id)`` (the
  chunk-keyed stream of streaming.py), routes the chunk's rows through
  the partial tree, and adds the chunk's left-statistics table to a
  ``(R, F, B, N, K)`` float32 accumulator. On the card the table is the
  histogram kernel's (``_TreeBase._chunk_level_hist``: the chunk's bin
  codes, read through each replica's column index, so the chunk is
  never copied per replica): one ``bin_codes`` and one histogram launch
  per chunk per level. After the pass the split choice is the
  in-memory ``_select_splits`` with the in-memory feature masks;
- **last pass (leaves):** route to full depth, add up per-leaf
  statistics, finalize as the in-memory fit does.

Integral statistics (bootstrap counts times one-hot classes) are summed
exactly: in int32 within a chunk on the card, and in float32 over
chunks, exact below 2**24. So streamed Gini trees are bitwise the JAX
package's.

Checkpoints: with ``checkpoint_dir`` the engine snapshots ``(edges,
the splits of every finished level, the pass cursor)`` after the edge
pass and after every level, in the JAX package's format
(``streaming.save_snapshot``); ``resume_from`` skips the finished
passes and runs only the rest, so a resumed fit launches ``bin_codes``
and the histogram only for the levels it has left, and equals the
uninterrupted fit bit for bit.

On a ``(data, replica)`` mesh each chunk of a level or leaf pass runs as
one ``shard_map``: every replica shard accumulates its replicas' tables,
and on a data mesh shard i takes rows ``[i·rows, (i+1)·rows)`` of the
chunk (valid where ``off + arange(rows) < n_valid``), draws their
weights from the chunk key folded with i (the per-shard stream of the
in-memory data-sharded fit), runs ``bin_codes`` and the histogram on
them, and the tables sum over ``data`` before they are added up. The
edge pass stays global. The snapshot config records the data-axis size,
which keys the draws: a resume on another data size is refused. On a
mesh that spans processes each process places only its shards of a
chunk (``multihost.global_put``) and every chunk's tables are gathered
whole (``multihost.to_host``) before they are added up, so every
process selects the same splits; only process 0 writes a snapshot.

Telemetry: the ``tree_pass`` spans (``kind`` edges, level, leaves),
each chunk's ``chunk_step`` span on ``sbt_chunk_seconds`` in the level
and leaf passes, and ``sbt_stream_chunks_total`` (``engine="tree"``),
as in the JAX package.
"""

from __future__ import annotations

import math
import time
from contextlib import closing
from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch.models.tree import (
    _quantile_edges,
    _take_feature,
    _TreeBase,
)
from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import (
    RNG_SCHEMA,
    bootstrap_weights,
    feature_subspaces,
    replica_init_fit_keys,
)
from spark_bagging_tpu_torch.ops.reduce import maybe_psum
from spark_bagging_tpu_torch.parallel.compat import P, axis_index, shard_map
from spark_bagging_tpu_torch.parallel.mesh import DATA_AXIS, REPLICA_AXIS
from spark_bagging_tpu_torch.parallel.multihost import global_put, to_local
from spark_bagging_tpu_torch.streaming import (
    _CHUNK_STREAM,
    _load_stream_checkpoint,
    check_resume_config,
    check_stream_mesh,
    chunk_context,
    key_data,
    learner_fingerprint,
    save_snapshot,
    to_device,
)
from spark_bagging_tpu_torch.utils.device import synchronize
from spark_bagging_tpu_torch.utils.io import ChunkSource


def _route_partial(feats, thrs, X, cols, R):
    """Node of each row ``(R, n)`` int32 under the levels grown so far
    (``feats``/``thrs``: one ``(R, 2^level)`` tensor a level), reading X
    through ``cols`` (None: every feature)."""
    rel = torch.zeros((R, X.shape[0]), dtype=torch.int32, device=X.device)
    for f_lvl, t_lvl in zip(feats, thrs):
        f_row = f_lvl.gather(1, rel.long())
        t_row = t_lvl.gather(1, rel.long())
        x_sel = _take_feature(X, f_row, cols)
        rel = rel * 2 + (x_sel > t_row).to(torch.int32)
    return rel


def fit_tree_ensemble_stream(
    learner: _TreeBase,
    source: ChunkSource,
    key: torch.Tensor,
    n_replicas: int,
    n_outputs: int,
    *,
    sample_ratio: float = 1.0,
    bootstrap: bool = True,
    n_subspace: int | None = None,
    bootstrap_features: bool = False,
    mesh=None,
    checkpoint_dir: str | None = None,
    resume_from: str | None = None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, dict[str, Any]]:
    """Stream-fit a tree ensemble on the device ``key`` lies on (with
    ``mesh``: over the mesh, the tables gathered on ``key``'s device);
    the return contract of ``streaming.fit_ensemble_stream``.
    ``checkpoint_dir`` snapshots at every pass boundary (the state is
    ``O(R 2^d)``, not the mid-pass histogram); ``resume_from`` goes on
    after a snapshot's last finished pass."""
    if not getattr(learner, "tree_streamable", False):
        raise ValueError(
            f"{type(learner).__name__} is not tree-streamable "
            "(multi-round boosting needs margins over the whole "
            "dataset per round; stream a bagged forest instead)"
        )
    device = key.device
    n_features = source.n_features
    chunk_rows = source.chunk_rows
    data_size = 1
    if mesh is not None:
        data_size, _ = check_stream_mesh(mesh, n_replicas, chunk_rows)
    data_axis = DATA_AXIS if data_size > 1 else None
    if n_subspace is None:
        n_subspace = n_features
    identity = n_subspace == n_features and not bootstrap_features
    ids = torch.arange(n_replicas, dtype=torch.int64, device=device)
    subspaces = feature_subspaces(
        key, ids, n_features, n_subspace, replacement=bootstrap_features
    )
    row_key = prng.fold_in(key, _CHUNK_STREAM)
    d, B = learner.max_depth, learner.n_bins
    K = learner._stats_per_row(n_outputs)
    y_dtype = (torch.int64 if learner.task == "classification"
               else torch.float32)
    t0 = time.perf_counter()
    first_step_seconds = None

    # pass cursor: 0 the edge pass, 1..d the level passes, d+1 the leaves
    config = {
        "key": key_data(key),
        "n_replicas": n_replicas,
        "n_outputs": n_outputs,
        "sample_ratio": sample_ratio,
        "bootstrap": bootstrap,
        "n_subspace": n_subspace,
        "bootstrap_features": bootstrap_features,
        "chunk_rows": chunk_rows,
        "n_features": n_features,
        "n_rows": source.n_rows,
        "n_chunks": source.n_chunks,
        "rng_schema": RNG_SCHEMA,
        # the data-axis size the weight stream folds (1: no mesh)
        "data_size": data_size,
        "learner": learner_fingerprint(learner),
    }
    start_pass = 0
    state: dict | None = None
    if resume_from is not None:
        meta, state = _load_stream_checkpoint(resume_from)
        saved_cfg = meta.setdefault("config", {})
        saved_cfg.setdefault("n_rows", source.n_rows)
        saved_cfg.setdefault("n_chunks", source.n_chunks)
        check_resume_config(meta, config, resume_from)
        start_pass = meta["next_pass"]
        if start_pass >= 1 and "gains" not in state:
            raise ValueError(
                "tree-stream snapshot predates split-gain tracking "
                "(no 'gains' key) \u2014 re-run the fit to produce a "
                "current-format checkpoint"
            )
    feats, thrs, gains, curve = [], [], [], []

    def snapshot(next_pass: int) -> None:
        if checkpoint_dir is None:
            return
        host = lambda ts: [t.cpu().numpy() for t in ts]  # noqa: E731
        save_snapshot(checkpoint_dir, {
            "edges": edges.cpu().numpy(), "feats": host(feats),
            "thrs": host(thrs), "gains": host(gains), "curve": host(curve),
        }, {"config": config, "next_pass": next_pass})

    def chunks():
        """One pass: each host chunk as ``(c, X, y, n_valid)``, counted
        in ``sbt_stream_chunks_total`` once the caller is done with it;
        the first one's wait times the first step."""
        nonlocal first_step_seconds
        with closing(source.chunks()) as chunk_iter:
            for c, (Xc, yc, n_valid) in enumerate(chunk_iter):
                yield c, Xc, yc, n_valid
                telemetry.inc("sbt_stream_chunks_total",
                              labels={"engine": "tree"})
                if first_step_seconds is None:
                    synchronize(device)
                    first_step_seconds = time.perf_counter() - t0

    def place(Xc, yc):
        """A chunk's ``(X, y)`` on the device, or on a mesh row-sharded
        over ``data`` (each process its own shards)."""
        if mesh is None:
            return (to_device(Xc, device, torch.float32),
                    to_device(yc, device, y_dtype))
        return (global_put(np.asarray(Xc, np.float32), mesh,
                           P(DATA_AXIS, None)),
                global_put(torch.from_numpy(np.asarray(yc)).to(y_dtype),
                           mesh, P(DATA_AXIS)))

    def accumulate(body, acc):
        """One level or leaf pass: every chunk's table (``body``, over
        the mesh when there is one) added to ``acc``."""
        step = on_mesh(body)
        for c, Xc, yc, n_valid in chunks():
            with telemetry.span("chunk_step", metric="sbt_chunk_seconds",
                                chunk=c):
                X, y = place(Xc, yc)
                acc += to_local(step(c, n_valid, X, y, feats, thrs, ids,
                                     subspaces), device)
        return acc

    def local_weights(c, X, n_valid, rids):
        """The weights ``(R, rows)`` of this shard's block of chunk c,
        times its validity: the whole chunk off a data mesh; on one,
        shard i's rows ``[i·rows, (i+1)·rows)``, drawn from the chunk key
        folded with i."""
        rows = X.shape[0]
        valid, chunk_key = chunk_context(row_key, c, n_valid, chunk_rows)
        if data_axis is not None:
            i = axis_index(data_axis)
            chunk_key = prng.fold_in(chunk_key, i)
            valid = valid[i * rows:(i + 1) * rows]
        return bootstrap_weights(chunk_key, rids, rows, ratio=sample_ratio,
                                 replacement=bootstrap) * valid

    def on_mesh(body):
        """``body(c, n_valid, X, y, feats, thrs, rids, subs)`` a chunk,
        over the mesh when there is one: rows over ``data``, replicas
        over ``replica``, its tables summed over ``data`` and gathered in
        replica order."""
        def summed(c, n_valid, *args):
            return maybe_psum(body(c, n_valid, *args), data_axis)

        if mesh is None:
            return summed
        rep = P(REPLICA_AXIS)

        def run(c, n_valid, *args):
            return shard_map(
                lambda *a: summed(c, n_valid, *a), mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), rep, rep, rep,
                          rep),
                out_specs=rep, check_vma=False)(*args)

        return run

    if start_pass == 0:
        # -- pass 0: averaged per-chunk quantile edges over every
        #    feature (replicas read their subspace's rows of them later)
        e_sum = torch.zeros((n_features, B - 1), dtype=torch.float32,
                            device=device)
        e_cnt = torch.zeros((), dtype=torch.float32, device=device)
        n_chunks = 0
        with telemetry.span("tree_pass", kind="edges"):
            for _, Xc, _, n_valid in chunks():
                X = to_device(Xc, device, torch.float32)
                valid = (torch.arange(chunk_rows, device=device)
                         < n_valid).to(torch.float32)
                interior, nv = _quantile_edges(X, valid, B)
                has = (nv > 0).to(torch.float32)
                e_sum += torch.where(torch.isfinite(interior), interior,
                                     0.0) * has
                e_cnt += has
                n_chunks += 1
        if n_chunks == 0:
            raise ValueError("source yielded no chunks")
        edges = torch.cat([
            e_sum / torch.clamp_min(e_cnt, 1.0),
            torch.full((n_features, 1), math.inf, dtype=torch.float32,
                       device=device),
        ], dim=1).contiguous()
        snapshot(1)
    else:
        # the edge pass and start_pass - 1 levels finished before the
        # snapshot
        n_chunks = source.n_chunks
        edges = torch.as_tensor(np.array(state["edges"]),
                                device=device).contiguous()
        as_dev = lambda xs: [torch.as_tensor(np.array(x), device=device)  # noqa: E731
                             for x in xs]
        feats, thrs = as_dev(state["feats"]), as_dev(state["thrs"])
        gains, curve = as_dev(state["gains"]), as_dev(state["curve"])
    edges_r = edges if identity else edges[subspaces.long()]

    # -- passes 1..d: one histogram accumulation pass per level
    k_split = learner._n_split_features(n_subspace)
    fit_keys = replica_init_fit_keys(key, ids)[1]
    for level in range(len(feats), d):
        N = 2**level

        def level_table(c, n_valid, X, y, fls, tls, rids, subs, N=N):
            w = local_weights(c, X, n_valid, rids)
            sub_cols = None if identity else subs
            node = _route_partial(fls, tls, X, sub_cols, rids.shape[0])
            S = learner._row_stats(y, w, n_outputs)
            return learner._chunk_level_hist(
                X, S, edges, node, N, cols=sub_cols,
                integral=learner.integral_stats)

        hist = torch.zeros((n_replicas, n_subspace, B, N, K),
                           dtype=torch.float32, device=device)
        with telemetry.span("tree_pass", kind="level", level=level):
            hist = accumulate(level_table, hist)
        # the in-memory fit's per-split feature masks: the same draws
        # from each replica's fit key, folded with the level
        mask = (learner._level_feat_mask(fit_keys, level, N, n_subspace,
                                         k_split)
                if k_split is not None else None)
        bf, thr, score, gain = learner._select_splits(hist, edges_r, mask)
        del hist
        feats.append(bf)
        thrs.append(thr)
        gains.append(gain)
        curve.append(score)
        snapshot(level + 2)

    # -- last pass: leaf statistics
    def leaf_table(c, n_valid, X, y, fls, tls, rids, subs):
        w = local_weights(c, X, n_valid, rids)
        node = _route_partial(fls, tls, X, None if identity else subs,
                              rids.shape[0])
        return learner._leaf_stats(node, learner._row_stats(y, w, n_outputs))

    leaf_acc = torch.zeros((n_replicas, 2**d, K), dtype=torch.float32,
                           device=device)
    with telemetry.span("tree_pass", kind="leaves"):
        leaf_acc = accumulate(leaf_table, leaf_acc)
    params, aux_tree = learner._finalize_leaves(
        torch.cat(feats, dim=1), torch.cat(thrs, dim=1),
        torch.cat(gains, dim=1), leaf_acc, torch.stack(curve, dim=1))
    aux = {
        "loss": aux_tree["loss"],
        "n_chunks": n_chunks,
        "n_epochs": 1,
        "n_passes": d + 2,  # the edge pass, one per level, the leaf pass
        "stream_seconds": time.perf_counter() - t0,
        "first_step_seconds": first_step_seconds,
    }
    return params, subspaces, aux
