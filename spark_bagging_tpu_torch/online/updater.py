"""Streaming Poisson-weight updates over the stacked replica axis.

The port of the JAX package's ``online/updater.py``. The batch engine's
design (bootstraps are per-row WEIGHT vectors, replicas one stacked
params tree with a leading replica axis) is the form that admits online
updates: per-example Poisson(1) weights make online bagging consistent
with the batch bootstrap. An :class:`OnlineUpdater` wraps a FITTED
estimator and applies ``partial_fit(X, y)`` steps:

- **Weights.** Step ``t`` derives its base key from
  :func:`~spark_bagging_tpu_torch.ops.bootstrap.online_step_key` and
  feeds it to the same
  :func:`~spark_bagging_tpu_torch.ops.bootstrap.bootstrap_weights`
  schedule the batch fit uses: replica ``r`` of step ``t`` draws
  Poisson(1) row weights that depend only on ``(seed, t, r)``, bit for
  bit the JAX package's.
- **Update.** Each step runs the base learner's own ``fit`` over the
  estimator's replica chunks (``ensemble.map_replicas`` at the
  estimator's ``_eff_chunk()``), starting every replica from its
  current params; the result keeps the stacked layout the serving
  executor consumes. Only SGD-able learners (``streamable``) apply:
  their solvers refine given params (logistic's damped Newton, which
  launches the scaled-Gram kernel at the step's rows, GLM, SVM, the
  Adam learners; ridge re-solves its normal equations on the step's
  rows). Trees cannot move their params incrementally and are
  rejected.
- **Streaming OOB tap.** Before the update touches the params, each
  row is scored by exactly the replicas whose Poisson draw was 0
  (``ensemble.oob_replica_contrib``), feeding a running OOB quality
  estimate: test-then-train, so no row is scored by a replica that has
  trained on it in this step.

**Batch parity.** ``warm=False`` makes the first ``partial_fit`` replay
the batch fit itself (``ensemble.fit_ensemble`` with the estimator's
recorded sampling, subspace and pooled-start settings and its original
fit key, at its resolved chunk): a pass over the fit's rows reproduces
``estimator.fit`` bit for bit on the same device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.ensemble import (
    _gather_columns,
    fit_ensemble,
    map_replicas,
    oob_replica_contrib,
)
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import (
    bootstrap_weights,
    fit_key,
    online_step_key,
)

WEIGHT_MODES = ("poisson", "ones")


def _update_step(learner, params, subspaces, ids, X, y, key, *,
                 n_classes: int | None, identity_subspace: bool,
                 weight_mode: str, chunk_size: int | None):
    """One online-update step over the replica chunks: ``(new_params,
    oob_agg, oob_votes, losses)``. The OOB tap runs on the INCUMBENT
    params (test-then-train), its mask regenerated from the same draw
    the update consumes."""
    n = X.shape[0]

    def one(chunk):
        p, idx, rids = chunk
        Xs = X if identity_subspace else _gather_columns(X, idx)
        if weight_mode == "poisson":
            w = bootstrap_weights(key, rids, n, ratio=1.0,
                                  replacement=True)
            contrib, votes = oob_replica_contrib(
                learner, p, idx, rids, X, key,
                sample_ratio=1.0, bootstrap=True, n_classes=n_classes,
                identity_subspace=identity_subspace,
            )
        else:  # "ones": no resampling, hence no OOB rows
            R = rids.shape[0]
            w = torch.ones((R, n), dtype=torch.float32, device=X.device)
            shape = (R, n, n_classes) if n_classes is not None else (R, n)
            contrib = torch.zeros(shape, dtype=torch.float32,
                                  device=X.device)
            votes = torch.zeros((R, n), dtype=torch.float32,
                                device=X.device)
        p2, aux = learner.fit(p, Xs, y, w, fit_key(key, rids))
        # each chunk's OOB sums, one row a chunk, summed after the map
        return p2, contrib.sum(0, keepdim=True), votes.sum(0, keepdim=True), \
            aux["loss"]

    new_params, contribs, votes, losses = map_replicas(
        one, (params, subspaces, ids), chunk_size
    )
    return new_params, contribs.sum(0), votes.sum(0), losses


class OnlineUpdater:
    """Streaming Poisson-weight updates for one fitted bagging estimator
    (see module docstring).

    Single-writer by contract: ``partial_fit`` calls must be serialized
    by the caller; the updater is a deterministic state machine and
    carries no lock. ``seed=None`` derives the key stream from the
    estimator's own fit seed; pass a distinct seed for independent
    update streams over the same model. The steps run on the
    estimator's device.
    """

    def __init__(self, estimator: Any, *, seed: int | None = None,
                 weight_mode: str = "poisson", warm: bool = True,
                 labels: dict[str, Any] | None = None) -> None:
        estimator._check_fitted()
        if weight_mode not in WEIGHT_MODES:
            raise ValueError(
                f"weight_mode must be one of {WEIGHT_MODES}, got "
                f"{weight_mode!r}"
            )
        if getattr(estimator, "mesh", None) is not None:
            raise ValueError(
                "OnlineUpdater is single-device (like the serving "
                "executors): save() the mesh-fitted ensemble and "
                "load() it without a mesh first"
            )
        learner = estimator.base_learner_
        if not learner.streamable:
            raise ValueError(
                f"{type(learner).__name__} is not an SGD-able learner "
                "(streamable=False): its params cannot be refined "
                "incrementally, so online updates do not apply — refit "
                "offline and hot-swap instead"
            )
        if learner.uses_aux:
            raise ValueError(
                "aux-column learners (censoring etc.) are not supported "
                "online: the serving stream carries no aux channel"
            )
        # stream fits also set _fit_key; their designated guard
        # attribute is _fit_subspace_cfg=None (bagging.py fit_stream)
        if getattr(estimator, "_fit_subspace_cfg", None) is None:
            raise ValueError(
                "estimator carries no in-memory fit state "
                "(stream-fitted, or not fitted by this build): "
                "stream-fitted ensembles update from their own "
                "fit_stream path, not OnlineUpdater"
            )
        self._est = estimator
        self._learner = learner
        self._task = estimator.task
        self._n_outputs = (int(estimator.n_classes_)
                           if self._task == "classification" else 1)
        self._n_classes = (self._n_outputs
                           if self._task == "classification" else None)
        self._identity = bool(getattr(estimator, "_identity_subspace",
                                      True))
        self._chunk = estimator._eff_chunk()
        self._device = estimator._device
        self.weight_mode = weight_mode
        self.labels = dict(labels) if labels else None
        self.seed = int(estimator.seed if seed is None else seed)
        self._base_key = prng.key(self.seed, self._device)
        self._subspaces = estimator.subspaces_
        self._ids = torch.arange(int(estimator.n_estimators_),
                                 dtype=torch.int64, device=self._device)
        self._params = estimator.ensemble_ if warm else None
        self._step = 0
        self._rows = 0
        # running OOB accumulators (float64 host side, deterministic):
        # classification counts correct/voted; regression folds SSE
        # plus the voted rows' label moments for a running R²
        self._oob_correct = 0.0
        self._oob_voted = 0.0
        self._oob_sse = 0.0
        self._oob_y_n = 0.0
        self._oob_y_sum = 0.0
        self._oob_y_sumsq = 0.0
        self._last_losses: np.ndarray | None = None

    # -- introspection --------------------------------------------------

    @property
    def steps(self) -> int:
        return self._step

    @property
    def rows_seen(self) -> int:
        return self._rows

    @property
    def oob_rows(self) -> int:
        return int(self._oob_voted)

    def oob_estimate(self) -> float | None:
        """Running streaming OOB quality: accuracy (classification) or
        R² (regression) over every row at least one OOB replica voted
        on; ``None`` until the first vote."""
        if self._oob_voted <= 0:
            return None
        if self._task == "classification":
            return float(self._oob_correct / self._oob_voted)
        sst = self._oob_y_sumsq - self._oob_y_sum ** 2 / self._oob_y_n
        if sst <= 0:
            return 0.0
        return float(1.0 - self._oob_sse / sst)

    # -- the step -------------------------------------------------------

    def _encode_y(self, y) -> np.ndarray:
        y = np.asarray(y).ravel()
        if self._task != "classification":
            return np.asarray(y, np.float32)
        classes = np.asarray(self._est.classes_)
        enc = np.searchsorted(classes, y)
        enc_clip = np.clip(enc, 0, len(classes) - 1)
        if not np.array_equal(classes[enc_clip], y):
            unknown = sorted(set(np.unique(y)) - set(classes.tolist()))
            raise ValueError(
                f"y carries labels outside the fitted class set: "
                f"{unknown[:5]} (online updates cannot grow the label "
                "space; register the new space under a new model)"
            )
        return np.asarray(enc_clip, np.int64)

    def partial_fit(self, X, y) -> dict[str, Any]:
        """Apply one streaming update step over ``(X, y)``; returns a
        compact step report (step index, rows, OOB rows/estimate).

        The first call with ``warm=False`` replays the estimator's batch
        fit instead (the parity anchor, see the module docstring); every
        later call is a warm Poisson-weighted step.
        """
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self._est.n_features_in_:
            raise ValueError(
                f"X must be (n, {self._est.n_features_in_}), got "
                f"{X.shape}"
            )
        y_enc = self._encode_y(y)
        if y_enc.shape[0] != X.shape[0]:
            raise ValueError("X and y row counts differ")
        n = int(X.shape[0])
        Xt = torch.as_tensor(X, device=self._device)
        yt = torch.as_tensor(y_enc, device=self._device)
        oob_new = 0
        if self._params is None:
            # cold start: the batch engine with the estimator's recorded
            # config and original fit key, the one path bit-identical to
            # the batch fit
            ratio, replacement = self._est._fit_sampling
            n_sub, boot_feat = self._est._fit_subspace_cfg
            params, subspaces, aux = fit_ensemble(
                self._learner, Xt, yt, self._est._fit_key, self._ids,
                self._n_outputs, sample_ratio=ratio, bootstrap=replacement,
                n_subspace=n_sub, bootstrap_features=boot_feat,
                chunk_size=self._chunk,
                use_pooled_init=self._est._fit_pooled_gate,
            )
            self._params = params
            self._subspaces = subspaces
            self._last_losses = aux["loss"].cpu().numpy()
        else:
            key = online_step_key(self._base_key, self._step)
            params, oob_agg, oob_votes, losses = _update_step(
                self._learner, self._params, self._subspaces, self._ids,
                Xt, yt, key, n_classes=self._n_classes,
                identity_subspace=self._identity,
                weight_mode=self.weight_mode, chunk_size=self._chunk,
            )
            self._params = params
            self._last_losses = losses.cpu().numpy()
            oob_new = self._fold_oob(
                oob_agg.cpu().numpy(), oob_votes.cpu().numpy(), y_enc
            )
        self._step += 1
        self._rows += n
        if telemetry.enabled():
            telemetry.inc("sbt_online_updates_total", labels=self.labels)
            telemetry.inc("sbt_online_examples_total", float(n),
                          labels=self.labels)
            if oob_new:
                telemetry.inc("sbt_online_oob_rows_total",
                              float(oob_new), labels=self.labels)
            est = self.oob_estimate()
            if est is not None:
                telemetry.set_gauge("sbt_online_oob_estimate", est,
                                    labels=self.labels)
        return {
            "step": self._step - 1,
            "rows": n,
            "oob_rows": oob_new,
            "oob_estimate": self.oob_estimate(),
        }

    def _fold_oob(self, agg: np.ndarray, votes: np.ndarray,
                  y_enc: np.ndarray) -> int:
        """Fold one step's OOB votes into the running estimate; returns
        the number of newly voted rows."""
        has = votes > 0
        voted = int(has.sum())
        if voted == 0:
            return 0
        if self._task == "classification":
            pred = agg.argmax(axis=1)
            self._oob_correct += float((pred[has] == y_enc[has]).sum())
            self._oob_voted += voted
            return voted
        yv = np.asarray(y_enc, np.float64)[has]
        pred = agg[has] / votes[has]
        self._oob_sse += float(((pred - yv) ** 2).sum())
        self._oob_voted += voted
        self._oob_y_n += voted
        self._oob_y_sum += float(yv.sum())
        self._oob_y_sumsq += float((yv ** 2).sum())
        return voted

    # -- materialization ------------------------------------------------

    def to_estimator(self) -> Any:
        """A fitted estimator carrying the updated stacked params: the
        publishable candidate. A shallow copy of the wrapped estimator
        with ``ensemble_`` rebound and the program cache's fingerprint
        token dropped, so the candidate captures under its own key; the
        batch-fit OOB attributes are dropped (they describe the OLD
        params), and the running streaming estimate rides in
        ``online_oob_estimate_``."""
        import copy as _copy

        if self._params is None:
            raise RuntimeError(
                "no params yet: warm=False updaters need one "
                "partial_fit before to_estimator()"
            )
        cand = _copy.copy(self._est)
        cand.ensemble_ = self._params
        cand.subspaces_ = self._subspaces
        for stale in ("oob_score_", "oob_decision_function_",
                      "oob_prediction_", "_fp_token"):
            if hasattr(cand, stale):
                try:
                    delattr(cand, stale)
                except AttributeError:
                    pass
        cand.online_steps_ = self._step
        cand.online_oob_estimate_ = self.oob_estimate()
        return cand
