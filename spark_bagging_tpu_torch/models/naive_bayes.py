"""Weighted naive Bayes: Gaussian, multinomial and Bernoulli.

The port of the JAX package's ``models/naive_bayes.py``, batched over a
leading replica axis. Each fit is closed form: the Poisson bootstrap
counts weight a few moment products over rows, ``(C, n) @ (n, F)`` a
replica, with a class-weighted row selector ``Yw[c, i] = w_i [y_i =
c]``. None of the three is streamable. Every product runs in float32
with TF32 off, as the JAX learners' float32 products.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

_LOG_2PI = 1.8378770664093453
_FLOOR = 1e-12


def _class_selector(y: torch.Tensor, w: torch.Tensor, C: int) -> torch.Tensor:
    """``Yw (R, C, n)``: each replica's weights on its class rows."""
    onehot = torch.nn.functional.one_hot(y.long(), C).to(torch.float32)
    return onehot.t()[None] * w[:, None, :]


def _rows_product(Yw: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Yw (R, C, n) @ X`` for a shared ``(n, F)`` or a per-replica
    ``(R, n, F)`` X: ``(R, C, F)``."""
    with fp32_matmul():
        return Yw @ X


def _weighted_nll(scores, y, w, w_sum):
    """Each replica's weighted mean NLL of its scores ``(R, n, C)``."""
    logp = torch.log_softmax(scores, dim=-1)
    idx = y.long().view(1, -1, 1).expand(logp.shape[0], -1, 1)
    nll = -logp.gather(-1, idx)[..., 0]
    return maybe_psum((w * nll).sum(dim=-1)) / w_sum


class GaussianNB(BaseLearner):
    """Gaussian naive Bayes with sample-weight support.

    ``var_smoothing`` adds a fraction of the largest feature variance to
    every variance (sklearn's convention), floored at 1e-12, keeping
    log-likelihoods finite on constant features and empty draws.
    """

    task = "classification"
    streamable = False  # closed form; one pass, no gradient stream

    def __init__(self, var_smoothing: float = 1e-9):
        self.var_smoothing = var_smoothing

    def init_params(self, keys, n_features, n_outputs):
        R, dev = keys.shape[0], keys.device

        def full(shape, v):
            return torch.full((R, *shape), v, dtype=torch.float32, device=dev)

        return {
            "log_prior": full((n_outputs,), 0.0),
            # means relative to a global shift (the weighted feature
            # means), so fit and predict moments stay O(std)
            "shift": full((n_features,), 0.0),
            "mean": full((n_outputs, n_features), 0.0),
            "var": full((n_outputs, n_features), 1.0),
        }

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        return float(4 * n_rows * n_features * n_outputs
                     + 4 * n_rows * n_outputs)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del device
        # the shifted X and its square (n, F) a replica, twice (the fit's
        # moments, then the reported loss's scores), the selector (C, n),
        # and the scores and log-probs of the loss (n, C)
        return float(4 * (4 * n_rows * n_features + 3 * n_rows * n_outputs
                          + 2 * n_rows))

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None):
        del keys, prepared
        C = params["mean"].shape[1]
        X = X.to(torch.float32)
        w = sample_weight.to(torch.float32)
        Yw = _class_selector(y, w, C)
        cls_w = maybe_psum(Yw.sum(dim=-1))                     # (R, C)
        w_sum = torch.clamp_min(cls_w.sum(dim=-1), _FLOOR)     # (R,)
        denom = torch.clamp_min(cls_w, _FLOOR)[..., None]
        # moments about the global weighted mean: raw E[x²] − μ² cancels
        # in float32 for features far from 0
        with fp32_matmul():
            if X.dim() == 2:
                gmean = maybe_psum(w @ X) / w_sum[:, None]     # (R, F)
            else:
                gmean = maybe_psum(torch.bmm(w[:, None], X)[:, 0]) \
                    / w_sum[:, None]
        Xs = X - gmean[:, None, :]                             # (R, n, F)
        s1 = maybe_psum(_rows_product(Yw, Xs))                 # (R, C, F)
        s2 = maybe_psum(_rows_product(Yw, Xs * Xs))
        dmean = s1 / denom
        var = torch.clamp_min(s2 / denom - dmean**2, 0.0)
        # smoothing from the largest global variance: the one-hot rows
        # partition the weights, so the global second moment is sum_c s2
        gvar = torch.clamp_min(s2.sum(dim=1) / w_sum[:, None], 0.0)
        var = var + torch.clamp_min(
            self.var_smoothing * gvar.amax(dim=-1), _FLOOR)[:, None, None]
        log_prior = torch.log(torch.clamp_min(cls_w, _FLOOR)
                              / w_sum[:, None])
        params = {"log_prior": log_prior, "shift": gmean, "mean": dmean,
                  "var": var}
        loss = _weighted_nll(self.predict_scores(params, X), y, w, w_sum)
        return params, {"loss": loss, "loss_curve": loss[:, None]}

    def predict_scores(self, params, X):
        """Joint log-likelihood ``(R, n, C)``: log prior + sum_f log
        N(x_f), X centered on the stored shift before the expanded
        quadratic, whose cross term is one product."""
        Xs = X.to(torch.float32) - params["shift"][:, None, :]
        mean, var = params["mean"], params["var"]              # (R, C, F)
        inv = 1.0 / var
        with fp32_matmul():
            quad = ((Xs * Xs) @ inv.transpose(1, 2)
                    - 2.0 * (Xs @ (mean * inv).transpose(1, 2))
                    + (mean * mean * inv).sum(dim=-1)[:, None, :])
        log_norm = (torch.log(var) + _LOG_2PI).sum(dim=-1)[:, None, :]
        return params["log_prior"][:, None, :] - 0.5 * (quad + log_norm)


def _weighted_class_counts(Xc, y, w, C):
    """Count naive Bayes' statistics: per-class weight totals ``(R, C)``,
    the weight sums ``(R,)``, the weighted feature counts ``(R, C, F)``
    and the log priors."""
    Yw = _class_selector(y, w, C)
    cls_w = maybe_psum(Yw.sum(dim=-1))
    w_sum = torch.clamp_min(cls_w.sum(dim=-1), _FLOOR)
    counts = maybe_psum(_rows_product(Yw, Xc))
    log_prior = torch.log(torch.clamp_min(cls_w, _FLOOR) / w_sum[:, None])
    return cls_w, w_sum, counts, log_prior


class _CountNB(BaseLearner):
    """What the two count models share: validation and the cost model."""

    task = "classification"
    streamable = False  # closed form; one pass, no gradient stream

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        return float(2 * n_rows * n_features * n_outputs
                     + 4 * n_rows * n_outputs)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del n_features, device
        # the selector (C, n) and the reported loss's scores and
        # log-probs (n, C) a replica; the counts are (C, F)
        return float(4 * (3 * n_rows * n_outputs + 2 * n_rows))

    @staticmethod
    def _check_alpha(alpha: float) -> float:
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        return alpha


class MultinomialNB(_CountNB):
    """Weighted multinomial naive Bayes over count features with Laplace
    smoothing ``alpha``: one weighted-count product a fit. Features must
    be non-negative (counts, tf-idf); negative inputs give an undefined
    model, as in Spark and the JAX package."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = self._check_alpha(alpha)

    def init_params(self, keys, n_features, n_outputs):
        R, dev = keys.shape[0], keys.device
        return {
            "log_prior": torch.zeros((R, n_outputs), device=dev),
            "log_theta": torch.zeros((R, n_outputs, n_features), device=dev),
        }

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None):
        del keys, prepared
        C = params["log_theta"].shape[1]
        X = X.to(torch.float32)
        w = sample_weight.to(torch.float32)
        _, w_sum, counts, log_prior = _weighted_class_counts(X, y, w, C)
        # alpha = 0 with a zero count would give log(0) and then 0 * -inf
        # in the score product: the floor keeps the cell finite
        sm = torch.clamp_min(counts + self.alpha, _FLOOR)
        log_theta = torch.log(sm) - torch.log(sm.sum(dim=-1))[..., None]
        params = {"log_prior": log_prior, "log_theta": log_theta}
        loss = _weighted_nll(self.predict_scores(params, X), y, w, w_sum)
        return params, {"loss": loss, "loss_curve": loss[:, None]}

    def predict_scores(self, params, X):
        with fp32_matmul():
            return (params["log_prior"][:, None, :]
                    + X.to(torch.float32)
                    @ params["log_theta"].transpose(1, 2))


class BernoulliNB(_CountNB):
    """Weighted Bernoulli naive Bayes over features binarized at
    ``binarize`` (x > binarize is 1), Laplace smoothing ``alpha``."""

    def __init__(self, alpha: float = 1.0, binarize: float = 0.0):
        self.alpha = self._check_alpha(alpha)
        self.binarize = binarize

    def init_params(self, keys, n_features, n_outputs):
        R, dev = keys.shape[0], keys.device
        half = torch.full((R, n_outputs, n_features), -0.6931472,
                          dtype=torch.float32, device=dev)
        return {
            "log_prior": torch.zeros((R, n_outputs), device=dev),
            "log_theta": half,
            "log_1m_theta": half.clone(),
        }

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None):
        del keys, prepared
        C = params["log_theta"].shape[1]
        Xb = (X > self.binarize).to(torch.float32)
        w = sample_weight.to(torch.float32)
        cls_w, w_sum, counts, log_prior = _weighted_class_counts(Xb, y, w, C)
        theta = (counts + self.alpha) / (
            torch.clamp_min(cls_w, _FLOOR) + 2.0 * self.alpha)[..., None]
        # alpha = 0 can put theta at 0 or 1; the margin must survive
        # float32 (1 - 1e-12 rounds to 1), so 1e-6
        theta = torch.clamp(theta, 1e-6, 1.0 - 1e-6)
        params = {"log_prior": log_prior, "log_theta": torch.log(theta),
                  "log_1m_theta": torch.log1p(-theta)}
        # the binary matrix scored directly: predict_scores would binarize
        # it again, which is wrong where binarize is outside [0, 1)
        loss = _weighted_nll(self._scores_from_binary(params, Xb), y, w,
                             w_sum)
        return params, {"loss": loss, "loss_curve": loss[:, None]}

    @staticmethod
    def _scores_from_binary(params, Xb):
        lt, l1m = params["log_theta"], params["log_1m_theta"]
        # sum_f x log(theta) + (1 - x) log(1 - theta)
        #   = sum_f log(1 - theta) + x (log(theta) - log(1 - theta))
        with fp32_matmul():
            return (params["log_prior"][:, None, :]
                    + l1m.sum(dim=-1)[:, None, :]
                    + Xb @ (lt - l1m).transpose(1, 2))

    def predict_scores(self, params, X):
        return self._scores_from_binary(
            params, (X > self.binarize).to(torch.float32))
