"""Weighted generalized linear models by IRLS (Spark ML's
``GeneralizedLinearRegression``).

The port of the JAX package's ``models/glm.py``, batched over a leading
replica axis: exponential-family regression (gaussian, poisson, gamma,
binomial, tweedie) with a link, fit by iteratively reweighted least
squares. Each iteration is one working-weighted Gram ``Xb^T diag(w
(dmu/deta)^2 / V) Xb`` a replica, a batched Cholesky solve, and a
step-halving line search on the deviance (a log link can overshoot into
``exp`` overflow). The Gram is a plain float32 product with TF32 off,
as in the JAX package, where no Pallas kernel computes it. The clamps
of the links and deviances are the JAX package's.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.models.base import (
    BaseLearner,
    PooledStartMixin,
    augment_bias,
)
from spark_bagging_tpu_torch.models.linear import _linear
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

_SOLVER_DAMPING = 1e-3
_ETA_CLIP = 30.0  # exp(30) ~ 1e13: far past any sane mean, no overflow
_EPS = 1e-8
_STEPS = (1.0, 0.5, 0.25, 0.0)

_FAMILIES = ("gaussian", "poisson", "gamma", "binomial", "tweedie")
_LINKS = ("identity", "log", "logit")
_DEFAULT_LINK = {
    "gaussian": "identity",
    "poisson": "log",
    # the canonical gamma link is the inverse; log is the safe standard
    "gamma": "log",
    "binomial": "logit",
    "tweedie": "log",
}


def _xlogy_ratio(y: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``y log(max(y, eps) / mu)`` where y > 0, else 0."""
    return torch.where(y > 0, y * torch.log(torch.clamp_min(y, _EPS) / mu),
                       0.0)


class GeneralizedLinearRegression(PooledStartMixin, BaseLearner):
    """Exponential-family regression with a link function: ``family``,
    ``link`` (None: the family's default), ``variance_power`` (tweedie's
    p in V(mu) = mu^p, in (1, 2)), ``l2`` ridge penalty, ``max_iter``
    IRLS iterations. ``predict_scores`` is the response-scale mean mu,
    so a bagged regressor averages means."""

    task = "regression"
    streamable = True
    _pooled_leaf = "beta"
    _pooled_leaf_ndim = 1

    def __init__(
        self,
        family: str = "gaussian",
        link: str | None = None,
        variance_power: float = 1.5,
        l2: float = 1e-6,
        max_iter: int = 8,
        precision: str = "highest",
        init: str = "zeros",
        pooled_iter: int = 5,
    ):
        if family not in _FAMILIES:
            raise ValueError(
                f"family must be one of {_FAMILIES}, got {family!r}"
            )
        if link is not None and link not in _LINKS:
            raise ValueError(
                f"link must be None or one of {_LINKS}, got {link!r}"
            )
        if link == "logit" and family != "binomial":
            raise ValueError("logit link requires the binomial family")
        if family == "tweedie" and not 1.0 < variance_power < 2.0:
            # the compound-Poisson range, where the deviance below holds
            raise ValueError(
                "tweedie variance_power must be in (1, 2), got "
                f"{variance_power}"
            )
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        gram_op_dtype(precision)  # reject an unknown name up front
        self.family = family
        self.link = link
        self.variance_power = variance_power
        self.l2 = l2
        self.max_iter = max_iter
        self.precision = precision
        # the pooled start needs a convex deviance: each family's default
        # link; fit_stream has no pooled pre-pass
        self.validate_init(init)
        if init == "pooled" and link is not None \
                and link != _DEFAULT_LINK[family]:
            raise ValueError(
                "init='pooled' requires the family's default link "
                f"({_DEFAULT_LINK[family]!r} for {family!r}): the "
                f"deviance under link={link!r} is not convex in beta, "
                "so a shared warm start would collapse ensemble "
                "diversity instead of preserving per-replica optima"
            )
        self.init = init
        self.pooled_iter = pooled_iter

    # -- link and family ------------------------------------------------

    def _resolved_link(self) -> str:
        return self.link or _DEFAULT_LINK[self.family]

    def _mean(self, eta):
        """mu = g^-1(eta), clipped so the log link's exp stays finite."""
        link = self._resolved_link()
        if link == "identity":
            return eta
        if link == "log":
            return torch.exp(torch.clamp(eta, -_ETA_CLIP, _ETA_CLIP))
        return torch.sigmoid(eta)  # logit

    def _dmu_deta(self, mu):
        link = self._resolved_link()
        if link == "identity":
            return torch.ones_like(mu)
        if link == "log":
            return mu
        return mu * (1.0 - mu)  # logit

    def _variance(self, mu):
        """The family's variance function V(mu)."""
        if self.family == "gaussian":
            return torch.ones_like(mu)
        if self.family == "poisson":
            return torch.clamp_min(mu, _EPS)
        if self.family == "gamma":
            return torch.clamp_min(mu, _EPS) ** 2
        if self.family == "binomial":
            return torch.clamp_min(mu * (1.0 - mu), _EPS)
        return torch.clamp_min(mu, _EPS) ** self.variance_power  # tweedie

    def _unit_deviance(self, y, mu):
        """Per-row deviance d(y, mu) >= 0, the IRLS objective."""
        if self.family == "gaussian":
            return (y - mu) ** 2
        if self.family == "poisson":
            mu = torch.clamp_min(mu, _EPS)
            return 2.0 * (_xlogy_ratio(y, mu) - (y - mu))
        if self.family == "gamma":
            mu = torch.clamp_min(mu, _EPS)
            ys = torch.clamp_min(y, _EPS)
            return 2.0 * ((y - mu) / mu - torch.log(ys / mu))
        if self.family == "binomial":
            mu = torch.clamp(mu, _EPS, 1.0 - _EPS)
            t1 = torch.where(
                y < 1,
                (1.0 - y) * torch.log(torch.clamp_min(1.0 - y, _EPS)
                                      / (1.0 - mu)),
                0.0,
            )
            return 2.0 * (_xlogy_ratio(y, mu) + t1)
        # tweedie, 1 < p < 2
        p = self.variance_power
        mu = torch.clamp_min(mu, _EPS)
        yp = torch.clamp_min(y, 0.0)
        return 2.0 * (
            torch.where(y > 0, yp ** (2.0 - p) / ((1.0 - p) * (2.0 - p)), 0.0)
            - yp * mu ** (1.0 - p) / (1.0 - p)
            + mu ** (2.0 - p) / (2.0 - p)
        )

    # -- the learner contract ------------------------------------------

    def init_params(self, keys, n_features, n_outputs):
        del n_outputs
        return {"beta": torch.zeros((keys.shape[0], n_features + 1),
                                    dtype=torch.float32, device=keys.device)}

    def predict_scores(self, params, X):
        """The response-scale mean mu, ``(R, n)``."""
        return self._mean(_linear(X, params["beta"]))

    def linear_beta(self, params):
        """The identity link's prediction is linear in beta (the bagged
        mean collapses to one model); other links' are not."""
        if self._resolved_link() == "identity":
            return params["beta"]
        return None

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        del n_outputs
        n, d = n_rows, n_features + 1
        # per iteration: the weighted Gram, right-hand side, solve and
        # the line search
        return float(self.max_iter * (2 * n * d * d + 8 * n * d + d**3 / 3))

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del n_outputs, device
        # the bias-augmented X and its working-weighted copy (n, d+1), and
        # the working vectors (eta, mu, its derivative, V, the residual,
        # the weights, D and the candidates' etas) at (n,)
        return float(4 * n_rows * (2 * (n_features + 1) + 10))

    # -- the streaming contract -----------------------------------------

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        del n_outputs  # scalar linear predictor
        return float(6 * chunk_rows * (n_features + 1))

    def row_loss(self, params, X, y):
        """Half the unit deviance, ``(R, n)``."""
        return 0.5 * self._unit_deviance(y.to(torch.float32),
                                         self.predict_scores(params, X))

    def penalty(self, params):
        return 0.5 * self.l2 * (params["beta"][:, :-1] ** 2).sum(dim=-1)

    # ------------------------------------------------------------------

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del keys, prepared
        Xb = augment_bias(X.to(torch.float32))
        yf = y.to(torch.float32)
        w = sample_weight.to(torch.float32)
        # floor: all-zero bootstrap draws must stay finite
        w_sum = torch.clamp_min(maybe_psum(w.sum(dim=-1), axis_name),
                                1e-12)                               # (R,)
        beta = params["beta"]
        d = Xb.shape[-1]
        pen = torch.full((d,), self.l2, dtype=torch.float32,
                         device=beta.device)
        pen[-1] = 0.0
        eye = torch.eye(d, dtype=torch.float32, device=beta.device)

        def objective(eta, b):
            """Half-deviance + penalty from eta = Xb @ b, ``(R,)``."""
            dev = maybe_psum((w * self._unit_deviance(
                yf, self._mean(eta))).sum(dim=-1), axis_name) / w_sum
            return 0.5 * dev + 0.5 * self.l2 * (b[:, :-1] ** 2).sum(dim=-1)

        def linear(b):
            return (Xb @ b[..., None])[..., 0]

        losses = []
        with fp32_matmul():
            for _ in range(self.max_iter):
                eta = linear(beta)                                 # (R, n)
                mu = self._mean(eta)
                dmu = self._dmu_deta(mu)
                V = self._variance(mu)
                losses.append(objective(eta, beta))
                # the GLM score: -Xb^T [w (y - mu) dmu/deta / V]
                r = w * (yf - mu) * dmu / V
                G = -maybe_psum((Xb.transpose(-1, -2) @ r[..., None])[..., 0],
                                axis_name) / w_sum[:, None] + pen * beta
                # Fisher information: Xb^T diag(w (dmu/deta)^2 / V) Xb
                s = w * dmu * dmu / V
                H = maybe_psum((Xb * s[..., None]).transpose(-1, -2) @ Xb,
                               axis_name) / w_sum[:, None, None]
                H = H + torch.diag(pen) + _SOLVER_DAMPING * eye
                L, _ = torch.linalg.cholesky_ex(H)
                delta = torch.cholesky_solve(G[..., None], L)[..., 0]
                # eta at beta - s delta is eta - s D: one more product
                # prices every candidate
                D = linear(delta)
                cand = torch.stack([
                    objective(eta - s_ * D, beta - s_ * delta)
                    for s_ in _STEPS], dim=1)
                s_best = torch.tensor(_STEPS, device=beta.device)[
                    torch.argmin(cand, dim=1)]
                beta = beta - s_best[:, None] * delta
            final = objective(linear(beta), beta)
        return {"beta": beta}, {"loss": final,
                                "loss_curve": torch.stack(losses, dim=1)}
