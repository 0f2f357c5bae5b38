"""``BaggingClassifier``: the user-facing estimator, classifier surface.

The same parameters, fitted state and sklearn protocol (``fit`` /
``predict_proba`` / ``predict`` / ``score`` / ``get_params``) as the JAX
package's ``BaggingClassifier``, on one device. The fitted state keeps
the JAX layout: ``ensemble_`` (``{"W": (R, d+1, C)}`` for logistic
regression; ``feature``, ``threshold``, ``gain`` and ``leaf_logp`` for
trees) and ``subspaces_`` ``(R, n_subspace)`` int32, as tensors on the
estimator's device.

``device`` defaults to ``"cuda"`` and raises where CUDA is absent;
``device="cpu"`` must be asked for. The mesh, streaming and warm-start
surfaces are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numbers
import time

import numpy as np
import torch

from spark_bagging_tpu_torch.ensemble import (
    classifier_forward,
    fit_ensemble,
    oob_predict_scores,
)
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.logistic import LogisticRegression
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.utils.device import resolve_device, synchronize
from spark_bagging_tpu_torch.utils.params import ParamsMixin

_ROADMAP_SURFACES = "ROADMAP Queue A: bagging surfaces still to port"


def accuracy(y_true, y_pred, sample_weight=None) -> float:
    """(Weighted) share of equal labels."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if len(y_true) != len(y_pred):
        raise ValueError(
            f"y_true has {len(y_true)} samples, y_pred {len(y_pred)}"
        )
    correct = (y_true == y_pred).astype(np.float64)
    w = (np.ones(len(correct)) if sample_weight is None
         else np.asarray(sample_weight, np.float64).ravel())
    return float((correct * w).sum() / w.sum())


class BaggingClassifier(ParamsMixin):
    """Bagging meta-classifier: soft or hard vote over bootstrap replicas
    of the base learner (default :class:`LogisticRegression`)."""

    task = "classification"

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
        self.base_learner = base_learner
        self.n_estimators = n_estimators
        self.max_samples = max_samples
        self.bootstrap = bootstrap
        self.max_features = max_features
        self.bootstrap_features = bootstrap_features
        self.voting = voting
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
        parameters (``RandomForestClassifier`` builds its tree)."""
        learner = self.base_learner or LogisticRegression()
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
        if self.chunk_size is not None:
            return self.chunk_size
        return getattr(self, "_chunk_resolved", None)

    def _to_device(self, X, device: torch.device) -> torch.Tensor:
        if isinstance(X, torch.Tensor):
            X = X.to(device=device, dtype=torch.float32)
        else:
            X = torch.as_tensor(np.asarray(X, np.float32), device=device)
        if X.dim() != 2:
            raise ValueError(f"X must be 2-D, got shape {tuple(X.shape)}")
        return X

    def _check_fitted(self) -> None:
        if not hasattr(self, "ensemble_"):
            raise RuntimeError(
                f"{type(self).__name__} is not fitted; call fit(X, y) first"
            )

    # -- fit -----------------------------------------------------------

    def fit(self, X, y, sample_weight=None) -> "BaggingClassifier":
        """Fit the ensemble. ``sample_weight`` multiplies every replica's
        bootstrap counts; OOB membership stays weight-independent."""
        if self.mesh is not None:
            raise NotImplementedError(f"mesh fits ({_ROADMAP_SURFACES})")
        if self.warm_start:
            raise NotImplementedError(f"warm_start ({_ROADMAP_SURFACES})")
        device = resolve_device(self.device)
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1:
            raise ValueError(f"y must be 1-D, got shape {y.shape}")
        t0 = time.perf_counter()
        X = self._to_device(X, device)
        synchronize(device)
        h2d_seconds = time.perf_counter() - t0
        if y.shape[0] != X.shape[0]:
            raise ValueError("X and y row counts differ")
        classes, y_enc = np.unique(y, return_inverse=True)
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

    def _fit_engine(self, X, y, n_outputs, device, h2d_seconds,
                    sample_weight=None) -> None:
        from spark_bagging_tpu_torch.utils.memory import auto_chunk_size

        if self.n_estimators < 1:
            raise ValueError("n_estimators must be >= 1")
        n_rows, n_features = (int(s) for s in X.shape)
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

    # -- predict -------------------------------------------------------

    def predict_proba(self, X) -> np.ndarray:
        """Aggregated class probabilities ``(n, C)``."""
        self._check_fitted()
        X = self._to_device(X, self._device)
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features; the ensemble was fitted on "
                f"{self.n_features_in_}"
            )
        forward = classifier_forward(
            self._fitted_learner, self.n_classes_, self.n_estimators_,
            voting=self.voting, chunk_size=self._eff_chunk(),
            identity_subspace=self._identity_subspace,
        )
        return forward(self.ensemble_, self.subspaces_, X).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.predict_proba(X).argmax(axis=1)]

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

    def score(self, X, y, sample_weight=None) -> float:
        return accuracy(y, self.predict(X), sample_weight=sample_weight)

    # -- weights carried across from the JAX package --------------------

    @classmethod
    def from_jax_arrays(
        cls, ensemble, subspaces, *, classes, n_features: int,
        base_learner: BaseLearner | None = None, voting: str = "soft",
        chunk_size: int | None = None, device: str = "cuda",
    ) -> "BaggingClassifier":
        """A fitted estimator from a JAX ``BaggingClassifier``'s
        ``ensemble_`` and ``subspaces_`` (as numpy arrays), its
        ``classes_`` and ``n_features_in_``: both packages then predict
        from the same weights."""
        from spark_bagging_tpu_torch.convert import params_from_jax

        est = cls(base_learner=base_learner, voting=voting,
                  chunk_size=chunk_size, device=device)
        dev = resolve_device(device)
        params, subs = params_from_jax(ensemble, subspaces, device=dev)
        est.ensemble_, est.subspaces_ = params, subs
        est.classes_ = np.asarray(classes)
        est.n_classes_ = int(len(est.classes_))
        est.n_features_in_ = int(n_features)
        est.n_estimators_ = est.n_estimators = int(subs.shape[0])
        est._fitted_learner = est._learner()
        ident = torch.arange(n_features, dtype=torch.int32, device=dev)
        est._identity_subspace = bool(
            subs.shape[1] == n_features and (subs == ident).all()
        )
        est._device = dev
        return est
