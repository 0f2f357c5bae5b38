"""``BaggingClassifier`` and ``BaggingRegressor``: the user-facing estimators.

The same parameters, fitted state and sklearn protocol (``fit`` /
``predict_proba`` / ``predict`` / ``score`` / ``get_params``) as the JAX
package's estimators, on one device. ``_BaseBagging`` holds what both
tasks share: validation, the fit engine, OOB, the replica chunk, the
per-replica accessors (``base_learner_``, ``replica_params``,
``estimators_features_``, ``replica_weights``), the forward handles
(``aggregated_forward``, ``replica_forward``) and ``from_jax_arrays``.
The fitted state keeps the JAX layout: ``ensemble_`` (``{"W": (R, d+1,
C)}`` for logistic regression, ``{"beta": (R, d+1)}`` for linear
regression; ``feature``, ``threshold``, ``gain`` and ``leaf_logp`` or
``leaf_value`` for trees) and ``subspaces_`` ``(R, n_subspace)`` int32,
as tensors on the estimator's device.

``device`` defaults to ``"cuda"`` and raises where CUDA is absent;
``device="cpu"`` must be asked for. The mesh and warm-start surfaces
and the streamed fits and predicts are not ported yet and raise
``NotImplementedError``; ``save``/``load`` are not ported yet either
(ROADMAP Queue A 11).
"""

from __future__ import annotations

import numbers
import time

import numpy as np
import torch

from spark_bagging_tpu_torch.ensemble import (
    classifier_forward,
    classifier_replica_forward,
    fit_ensemble,
    oob_predict_scores,
    regressor_forward,
    regressor_replica_forward,
)
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.linear import LinearRegression
from spark_bagging_tpu_torch.models.logistic import LogisticRegression
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights
from spark_bagging_tpu_torch.utils.device import resolve_device, synchronize
from spark_bagging_tpu_torch.utils.metrics import accuracy, r2_score
from spark_bagging_tpu_torch.utils.params import ParamsMixin

_ROADMAP_SURFACES = "ROADMAP Queue A: bagging surfaces still to port"
_ROADMAP_STREAMS = "ROADMAP Queue A 11: out-of-core"


def _not_ported(name: str):
    """A method of the JAX estimators' out-of-core surface: raises
    ``NotImplementedError`` naming its Queue A item."""

    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{name} ({_ROADMAP_STREAMS})")

    method.__name__ = name
    method.__doc__ = f"Not ported yet ({_ROADMAP_STREAMS}); raises."
    return method


class _BaseBagging(ParamsMixin):
    """What both estimators share: validation, the fit engine, OOB,
    the replica accessors and the forward handles."""

    task: str
    _default_learner: type

    def __init__(
        self,
        base_learner: BaseLearner | None = None,
        n_estimators: int = 10,
        max_samples: float | int = 1.0,
        bootstrap: bool = True,
        max_features: float | int = 1.0,
        bootstrap_features: bool = False,
        oob_score: bool = False,
        seed: int = 0,
        chunk_size: int | None = None,
        mesh=None,
        warm_start: bool = False,
        device: str = "cuda",
    ):
        self.base_learner = base_learner
        self.n_estimators = n_estimators
        self.max_samples = max_samples
        self.bootstrap = bootstrap
        self.max_features = max_features
        self.bootstrap_features = bootstrap_features
        self.oob_score = oob_score
        self.seed = seed
        self.chunk_size = chunk_size
        self.mesh = mesh
        self.warm_start = warm_start
        self.device = device
        resolve_device(device)

    # -- helpers -------------------------------------------------------

    def _learner(self) -> BaseLearner:
        """The base learner to fit; a subclass may build it from its own
        parameters (the random forests build their tree)."""
        learner = self.base_learner or self._default_learner()
        if learner.task != self.task:
            raise ValueError(
                f"{type(learner).__name__} is a {learner.task} learner; "
                f"{type(self).__name__} needs {self.task}"
            )
        return learner

    def _sample_ratio(self, n_rows: int) -> float:
        """``max_samples`` as a Poisson rate: a float is the rate, an int
        an expected sample count (rate ``max_samples / n_rows``)."""
        ms = self.max_samples
        if isinstance(ms, bool) or not isinstance(ms, numbers.Real):
            raise ValueError(f"max_samples must be int or float, got {ms!r}")
        if isinstance(ms, numbers.Integral):
            ms = int(ms)
            if not 1 <= ms <= n_rows:
                raise ValueError(
                    f"int max_samples must be in [1, {n_rows}], got {ms}"
                )
            return ms / n_rows
        ms = float(ms)
        if not 0.0 < ms <= 1.0:
            raise ValueError(f"float max_samples must be in (0, 1], got {ms}")
        return ms

    def _n_subspace(self, n_features: int) -> int:
        if isinstance(self.max_features, float):
            return max(1, min(n_features,
                              round(self.max_features * n_features)))
        return max(1, min(n_features, int(self.max_features)))

    def _eff_chunk(self) -> int | None:
        """The replica chunk of predict and OOB: the caller's
        ``chunk_size``, else the one the fit resolved."""
        if self.chunk_size is not None:
            return self.chunk_size
        return getattr(self, "_chunk_resolved", None)

    def _validate_X(self, X, device: torch.device,
                    fitted: bool = False) -> torch.Tensor:
        """X as a 2-D float32 tensor on ``device``; a fitted estimator
        also checks its feature count."""
        if isinstance(X, torch.Tensor):
            X = X.to(device=device, dtype=torch.float32)
        else:
            X = torch.as_tensor(np.asarray(X, np.float32), device=device)
        if X.dim() != 2:
            raise ValueError(f"X must be 2-D, got shape {tuple(X.shape)}")
        if fitted and X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features; the ensemble was fitted on "
                f"{self.n_features_in_}"
            )
        return X

    def _check_fitted(self) -> None:
        if not hasattr(self, "ensemble_"):
            raise RuntimeError(
                f"{type(self).__name__} is not fitted; call fit(X, y) first"
            )

    def _check_replica(self, i: int) -> None:
        self._check_fitted()
        if not 0 <= i < self.n_estimators_:
            raise IndexError(
                f"replica {i} out of range [0, {self.n_estimators_})"
            )

    @staticmethod
    def _labels(y) -> np.ndarray:
        """``y`` as a 1-D array (a column vector is taken as one)."""
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {y.shape}")
        return y

    def _start_fit(self, X) -> tuple[torch.Tensor, torch.device, float]:
        """Refuse the surfaces not ported yet; X on the device, with the
        seconds the copy took."""
        if self.mesh is not None:
            raise NotImplementedError(f"mesh fits ({_ROADMAP_SURFACES})")
        if self.warm_start:
            raise NotImplementedError(f"warm_start ({_ROADMAP_SURFACES})")
        device = resolve_device(self.device)
        t0 = time.perf_counter()
        X = self._validate_X(X, device)
        synchronize(device)
        return X, device, time.perf_counter() - t0

    # -- fit -----------------------------------------------------------

    def _fit_engine(self, X, y, n_outputs, device, h2d_seconds,
                    sample_weight=None) -> None:
        from spark_bagging_tpu_torch.utils.memory import auto_chunk_size

        if self.n_estimators < 1:
            raise ValueError("n_estimators must be >= 1")
        n_rows, n_features = (int(s) for s in X.shape)
        if y.shape[0] != n_rows:
            raise ValueError("X and y row counts differ")
        ratio = self._sample_ratio(n_rows)
        if self.oob_score and not self.bootstrap and ratio >= 1.0:
            raise ValueError(
                "oob_score requires out-of-bag rows: use bootstrap=True or "
                "max_samples < 1.0"
            )
        row_mask = None
        if sample_weight is not None:
            sw = np.asarray(sample_weight, np.float32)
            if sw.shape != (n_rows,):
                raise ValueError(
                    f"sample_weight shape {sw.shape} != ({n_rows},)"
                )
            if (sw < 0).any():
                raise ValueError("sample_weight must be non-negative")
            if not (sw > 0).any():
                raise ValueError("sample_weight is all-zero")
            row_mask = torch.as_tensor(sw, device=device)
        learner = self._learner()
        n_subspace = self._n_subspace(n_features)
        key = prng.key(self.seed, device)
        ids = torch.arange(self.n_estimators, dtype=torch.int64, device=device)
        use_pooled = bool(
            learner.uses_pooled_init
            and learner.pooled_amortizes(int(self.n_estimators))
        )
        chunk_size = self.chunk_size
        if chunk_size is None:
            chunk_size = auto_chunk_size(
                learner, n_rows, n_subspace, n_outputs, self.n_estimators,
                device, n_features=n_features,
                bootstrap_features=self.bootstrap_features,
            )
        self._chunk_resolved = chunk_size
        t0 = time.perf_counter()
        params, subspaces, aux = fit_ensemble(
            learner, X, y, key, ids, n_outputs,
            sample_ratio=ratio, bootstrap=bool(self.bootstrap),
            n_subspace=n_subspace,
            bootstrap_features=bool(self.bootstrap_features),
            chunk_size=chunk_size, row_mask=row_mask,
            use_pooled_init=use_pooled,
        )
        losses = aux["loss"].cpu().numpy()  # completion barrier
        fit_seconds = time.perf_counter() - t0
        self.ensemble_ = params
        self.subspaces_ = subspaces
        self.n_features_in_ = n_features
        self.n_estimators_ = int(self.n_estimators)
        self._fit_key = key
        self._fit_n_rows = n_rows
        self._fitted_learner = learner
        self._fit_sampling = (ratio, bool(self.bootstrap))
        self._identity_subspace = (
            n_subspace == n_features and not self.bootstrap_features
        )
        self._device = device
        flops = learner.flops_per_fit(n_rows, n_subspace, n_outputs)
        n = self.n_estimators_
        e2e = fit_seconds + h2d_seconds
        self.fit_report_ = {
            "n_replicas": n,
            "fit_seconds": fit_seconds,
            "fits_per_sec": n / fit_seconds if fit_seconds > 0 else float("inf"),
            # eager execution: nothing is compiled ahead of the fit
            "compile_seconds": 0.0,
            "h2d_seconds": h2d_seconds,
            "fits_per_sec_e2e": n / e2e if e2e > 0 else float("inf"),
            "loss_mean": float(losses.mean()),
            "loss_std": float(losses.std()),
            "n_rows": n_rows,
            "n_features": n_features,
            "n_subspace": n_subspace,
            "backend": device.type,
            "n_devices": 1,
            "model_flops_per_fit": flops,
            "achieved_tflops": (flops * n / fit_seconds / 1e12
                                if flops and fit_seconds > 0 else None),
            "chunk_size_resolved": chunk_size,
        }

    # -- OOB -----------------------------------------------------------

    def _oob_scores(self, X, n_classes):
        """OOB aggregate and per-row vote counts, as numpy (rows with no
        vote are the caller's to exclude)."""
        ratio, replacement = self._fit_sampling
        agg, votes = oob_predict_scores(
            self._fitted_learner, self.ensemble_, self.subspaces_, X,
            self._fit_key,
            torch.arange(self.n_estimators_, dtype=torch.int64,
                         device=X.device),
            sample_ratio=ratio, bootstrap=replacement, n_classes=n_classes,
            chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )
        return agg.cpu().numpy(), votes.cpu().numpy()

    # -- the fitted replicas -------------------------------------------

    @property
    def base_learner_(self) -> BaseLearner:
        """The fitted base learner (its hyperparameters as at fit time)."""
        if not hasattr(self, "_fitted_learner"):
            # AttributeError, so hasattr() on an unfitted estimator is False
            raise AttributeError(
                f"{type(self).__name__} is not fitted; call fit() first"
            )
        return self._fitted_learner

    def replica_params(self, i: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
        """Replica ``i`` as ``(params, subspace_idx)`` numpy arrays (the
        analog of sklearn's ``estimators_[i]``): the slice of every
        params leaf and its feature indices."""
        self._check_replica(i)
        params = {k: v[i].cpu().numpy() for k, v in self.ensemble_.items()}
        return params, self.subspaces_[i].cpu().numpy()

    @property
    def estimators_features_(self) -> np.ndarray:
        """Per-replica feature indices ``(R, n_subspace)`` (sklearn's
        name for ``subspaces_``), as numpy."""
        self._check_fitted()
        return self.subspaces_.cpu().numpy()

    def replica_weights(self, i: int) -> np.ndarray:
        """Replica ``i``'s bootstrap weights over the training rows (the
        analog of sklearn's ``estimators_samples_[i]``), regenerated from
        the fit key; rows of weight 0 are its out-of-bag rows."""
        self._check_replica(i)
        if getattr(self, "_fit_n_rows", None) is None:
            raise ValueError(
                "replica_weights needs a fit of this estimator (weights "
                "carried across from the JAX package have no fit key)"
            )
        ratio, replacement = self._fit_sampling
        w = bootstrap_weights(
            self._fit_key, torch.tensor([i], device=self._fit_key.device),
            self._fit_n_rows, ratio=ratio, replacement=replacement,
        )
        return w[0].cpu().numpy()

    @property
    def feature_importances_(self) -> np.ndarray:
        """Mean decrease in impurity per (global) feature, normalized to
        sum 1 (Spark ML's ``featureImportances``), for a tree base
        learner: each replica's split gains, its subspace-relative split
        features mapped back through its subspace draw."""
        if not hasattr(self, "ensemble_"):
            # AttributeError, so hasattr() on an unfitted estimator is False
            raise AttributeError(
                "feature_importances_ is only available after fit"
            )
        if "gain" not in self.ensemble_:
            raise AttributeError(
                "feature_importances_ requires a tree base learner "
                "(fitted params carry no split gains)"
            )
        gains = self.ensemble_["gain"].cpu().numpy()             # (R, M)
        feats = self.ensemble_["feature"].long().cpu().numpy()   # (R, M)
        if not self._identity_subspace:
            subs = self.subspaces_.long().cpu().numpy()          # (R, k)
            feats = np.take_along_axis(subs, feats, axis=1)
        imp = np.zeros((self.n_features_in_,), np.float64)
        np.add.at(imp, feats.ravel(), gains.astype(np.float64).ravel())
        total = imp.sum()
        return imp / total if total > 0 else imp

    # -- forward handles -----------------------------------------------

    def aggregated_forward(self):
        """The fitted ensemble's aggregated forward ``(fn, params,
        subspaces)``: ``fn(params, subspaces, X)`` gives ``(n, C)``
        probabilities (classifier) or ``(n,)`` predictions (regressor)
        with every static choice (learner, vote, replica chunk, identity
        subspace) bound in, and is the closure ``predict_proba`` /
        ``predict`` runs on the device."""
        self._check_fitted()
        return self._forward_closure(), self.ensemble_, self.subspaces_

    def replica_forward(self):
        """The per-replica forward ``(fn, params, subspaces)``:
        :meth:`aggregated_forward` without the aggregation, ``(R, n, C)``
        for a classifier and ``(R, n)`` for a regressor; its mean over
        replicas is the aggregated output."""
        self._check_fitted()
        return self._replica_closure(), self.ensemble_, self.subspaces_

    fit_stream = _not_ported("fit_stream")
    predict_stream = _not_ported("predict_stream")
    score_stream = _not_ported("score_stream")

    def _forward_closure(self):
        raise NotImplementedError  # per task

    def _replica_closure(self):
        raise NotImplementedError  # per task

    # -- weights carried across from the JAX package --------------------

    @classmethod
    def from_jax_arrays(
        cls, ensemble, subspaces, *, n_features: int,
        base_learner: BaseLearner | None = None,
        chunk_size: int | None = None, device: str = "cuda", **params,
    ):
        """A fitted estimator from a JAX estimator's ``ensemble_`` and
        ``subspaces_`` (as numpy arrays) and its ``n_features_in_``: both
        packages then predict from the same weights. ``params`` are
        further constructor parameters (a classifier's ``voting``)."""
        from spark_bagging_tpu_torch.convert import params_from_jax

        est = cls(base_learner=base_learner, chunk_size=chunk_size,
                  device=device, **params)
        dev = resolve_device(device)
        ens, subs = params_from_jax(ensemble, subspaces, device=dev)
        est.ensemble_, est.subspaces_ = ens, subs
        est.n_features_in_ = int(n_features)
        est.n_estimators_ = est.n_estimators = int(subs.shape[0])
        est._fitted_learner = est._learner()
        ident = torch.arange(n_features, dtype=torch.int32, device=dev)
        est._identity_subspace = bool(
            subs.shape[1] == n_features and (subs == ident).all()
        )
        est._device = dev
        return est


class BaggingClassifier(_BaseBagging):
    """Bagging meta-classifier: soft or hard vote over bootstrap replicas
    of the base learner (default :class:`LogisticRegression`)."""

    task = "classification"
    _default_learner = LogisticRegression

    def __init__(
        self,
        base_learner: BaseLearner | None = None,
        n_estimators: int = 10,
        max_samples: float | int = 1.0,
        bootstrap: bool = True,
        max_features: float | int = 1.0,
        bootstrap_features: bool = False,
        voting: str = "soft",
        oob_score: bool = False,
        seed: int = 0,
        chunk_size: int | None = None,
        mesh=None,
        warm_start: bool = False,
        device: str = "cuda",
    ):
        super().__init__(
            base_learner, n_estimators, max_samples, bootstrap, max_features,
            bootstrap_features, oob_score, seed, chunk_size, mesh,
            warm_start, device,
        )
        self.voting = voting

    def fit(self, X, y, sample_weight=None) -> "BaggingClassifier":
        """Fit the ensemble. ``sample_weight`` multiplies every replica's
        bootstrap counts; OOB membership stays weight-independent."""
        X, device, h2d_seconds = self._start_fit(X)
        classes, y_enc = np.unique(self._labels(y), return_inverse=True)
        if len(classes) < 2:
            raise ValueError("y has a single class")
        self.classes_ = classes
        self.n_classes_ = int(len(classes))
        y_t = torch.as_tensor(y_enc.astype(np.int64), device=device)
        self._fit_engine(X, y_t, self.n_classes_, device, h2d_seconds,
                         sample_weight)
        if self.oob_score:
            counts, votes = self._oob_scores(X, self.n_classes_)
            self._finalize_oob(counts, votes, y_enc)
        return self

    def _finalize_oob(self, counts, votes, y_enc) -> None:
        """OOB vote counts -> ``oob_score_`` (accuracy over rows with at
        least one OOB vote) and ``oob_decision_function_`` (NaN where no
        replica voted)."""
        has_vote = votes > 0
        oob_pred = counts.argmax(axis=1)
        self.oob_score_ = accuracy(y_enc[has_vote], oob_pred[has_vote])
        self.oob_decision_function_ = np.where(
            has_vote[:, None], counts / np.maximum(votes, 1)[:, None], np.nan,
        )

    def _forward_closure(self):
        return classifier_forward(
            self._fitted_learner, self.n_classes_, self.n_estimators_,
            voting=self.voting, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def _replica_closure(self):
        return classifier_replica_forward(
            self._fitted_learner, self.n_classes_,
            voting=self.voting, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def predict_proba(self, X) -> np.ndarray:
        """Aggregated class probabilities ``(n, C)``."""
        self._check_fitted()
        X = self._validate_X(X, self._device, fitted=True)
        return self._forward_closure()(
            self.ensemble_, self.subspaces_, X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.predict_proba(X).argmax(axis=1)]

    def predict_log_proba(self, X) -> np.ndarray:
        """Log of the aggregated class probabilities (sklearn parity)."""
        return np.log(np.maximum(self.predict_proba(X), 1e-38))

    def decision_function(self, X) -> np.ndarray:
        """``(n,)`` margin ``p_1 - p_0`` for two classes, the ``(n, C)``
        probabilities otherwise (the sklearn ensemble convention)."""
        proba = self.predict_proba(X)
        if proba.shape[1] == 2:
            return proba[:, 1] - proba[:, 0]
        return proba

    predict_proba_stream = _not_ported("predict_proba_stream")

    def score(self, X, y, sample_weight=None) -> float:
        return accuracy(y, self.predict(X), sample_weight=sample_weight)

    @classmethod
    def from_jax_arrays(
        cls, ensemble, subspaces, *, classes, n_features: int,
        base_learner: BaseLearner | None = None, voting: str = "soft",
        chunk_size: int | None = None, device: str = "cuda",
    ) -> "BaggingClassifier":
        """:meth:`_BaseBagging.from_jax_arrays` with the JAX estimator's
        ``classes_``."""
        est = super().from_jax_arrays(
            ensemble, subspaces, n_features=n_features,
            base_learner=base_learner, chunk_size=chunk_size, device=device,
            voting=voting,
        )
        est.classes_ = np.asarray(classes)
        est.n_classes_ = int(len(est.classes_))
        return est


class BaggingRegressor(_BaseBagging):
    """Bagging meta-regressor: the mean over bootstrap replicas of the
    base learner (default :class:`LinearRegression`)."""

    task = "regression"
    _default_learner = LinearRegression

    def fit(self, X, y, sample_weight=None, aux=None) -> "BaggingRegressor":
        """Fit the ensemble; ``sample_weight`` as in
        :meth:`BaggingClassifier.fit`. ``aux`` is the per-row auxiliary
        column of a learner that declares ``uses_aux``; passing it to any
        other learner is an error."""
        self.__dict__.pop("_collapsed_beta_cache", None)
        if aux is not None:
            learner = self._learner()
            if not learner.uses_aux:
                raise ValueError(
                    f"aux was passed but {type(learner).__name__} does not "
                    "declare uses_aux (it would be silently ignored)"
                )
            raise NotImplementedError("the aux channel (ROADMAP Queue A 10)")
        X, device, h2d_seconds = self._start_fit(X)
        y = self._labels(y).astype(np.float32)
        y_t = torch.as_tensor(y, device=device)
        self._fit_engine(X, y_t, 1, device, h2d_seconds, sample_weight)
        if self.oob_score:
            sums, votes = self._oob_scores(X, None)
            self._finalize_oob(sums, votes, y)
        return self

    def _finalize_oob(self, sums, votes, y) -> None:
        """OOB prediction sums -> ``oob_prediction_`` (NaN where no
        replica voted) and ``oob_score_`` (R² over the voted rows)."""
        has_vote = votes > 0
        self.oob_prediction_ = np.where(
            has_vote, sums / np.maximum(votes, 1), np.nan
        )
        self.oob_score_ = r2_score(y[has_vote], self.oob_prediction_[has_vote])

    def _linear_collapse(self) -> np.ndarray | None:
        """``(D+1,)`` mean coefficients when the fitted learner's predict
        is linear in its params: the mean of R linear predictions is one
        prediction with the subspace-scattered mean betas, exactly, so
        ``predict`` is one host matvec. Cached per fit; None for a
        learner that is not linear."""
        if not hasattr(self, "_collapsed_beta_cache"):
            cache = None
            beta_fn = getattr(self._fitted_learner, "linear_beta", None)
            if beta_fn is not None:
                B = beta_fn(self.ensemble_).cpu().numpy().astype(np.float64)
                subs = self.subspaces_.cpu().numpy()
                out = np.zeros((B.shape[0], self.n_features_in_ + 1),
                               np.float64)
                rows = np.arange(B.shape[0])[:, None]
                # a column drawn twice (bootstrap_features) adds twice
                np.add.at(out, (rows, subs), B[:, :-1])
                out[:, -1] = B[:, -1]
                cache = out.mean(axis=0).astype(np.float32)
            self._collapsed_beta_cache = cache
        return self._collapsed_beta_cache

    def _forward_closure(self):
        """The device forward (the ensemble's mean), also for a linear
        learner: the collapse is ``predict``'s host-side path only."""
        return regressor_forward(
            self._fitted_learner, self.n_estimators_,
            chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def _replica_closure(self):
        return regressor_replica_forward(
            self._fitted_learner, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )

    def predict(self, X) -> np.ndarray:
        """Mean prediction ``(n,)``: one host matvec with the collapsed
        coefficients for a linear learner, the device forward for any
        other."""
        self._check_fitted()
        beta = self._linear_collapse()
        if beta is not None:
            if isinstance(X, torch.Tensor):
                X = X.detach().cpu()
            Xh = np.asarray(X, np.float32)
            if Xh.ndim != 2 or Xh.shape[1] != self.n_features_in_:
                raise ValueError(
                    f"X has shape {Xh.shape}; the ensemble was fitted on "
                    f"{self.n_features_in_} features"
                )
            return np.asarray(Xh @ beta[:-1] + beta[-1], np.float32)
        X = self._validate_X(X, self._device, fitted=True)
        return self._forward_closure()(
            self.ensemble_, self.subspaces_, X).cpu().numpy()

    def predict_quantiles(self, X, probs=(0.1, 0.5, 0.9)) -> np.ndarray:
        """Per-row quantiles averaged over replicas, for a learner with
        ``predict_quantiles``: the JAX package's survival learner, which
        is not ported yet (ROADMAP Queue A 10). Raises
        ``AttributeError`` for any other learner, as the JAX package
        does."""
        del X, probs  # the JAX estimator's signature
        self._check_fitted()
        learner = self.base_learner_
        if not hasattr(learner, "predict_quantiles"):
            raise AttributeError(
                f"{type(learner).__name__} has no predict_quantiles "
                "(only survival learners expose quantiles)"
            )
        raise NotImplementedError(
            "quantiles of a survival learner (ROADMAP Queue A 10)")

    def score(self, X, y, sample_weight=None) -> float:
        """R² of :meth:`predict`."""
        return r2_score(y, self.predict(X), sample_weight=sample_weight)
