"""Factorization machines (Spark ML's ``FMClassifier`` / ``FMRegressor``).

The port of the JAX package's ``models/fm.py``, batched over a leading
replica axis: the degree-2 model

    y(x) = w0 + w^T x + 1/2 sum_f [(v_f^T x)^2 - sum_i v_if^2 x_i^2]

whose factorized form is two products, ``X @ V`` and ``X² @ V²``,
trained by ``max_iter`` full-batch Adam steps (``optim.Adam``, optax's
arithmetic), one ``autograd`` call giving every replica's gradient. The
classifier is multinomial: C score columns under a softmax NLL. The
factors start at ``init_std`` times normal draws of each replica's init
key (``prng.normal``, within 3 ulps of ``jax.random.normal``). Every
product is float32 with TF32 off.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum
from spark_bagging_tpu_torch.optim import Adam


class _FMBase(BaseLearner):
    """Shared degree-2 FM machinery: ``factor_size`` is Spark's
    ``factorSize`` (the latent k), ``init_std`` the factors' initial
    scale, ``l2`` the penalty on linear weights and factors,
    ``max_iter`` / ``lr`` the Adam schedule."""

    streamable = True

    def __init__(
        self,
        factor_size: int = 8,
        l2: float = 1e-4,
        max_iter: int = 100,
        lr: float = 0.05,
        init_std: float = 0.01,
        precision: str = "high",
    ):
        if factor_size < 1:
            raise ValueError(
                f"factor_size must be >= 1, got {factor_size}"
            )
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        gram_op_dtype(precision)  # reject an unknown name up front
        self.factor_size = factor_size
        self.l2 = l2
        self.max_iter = max_iter
        self.lr = lr
        self.init_std = init_std
        self.precision = precision

    def _n_scores(self, n_outputs: int) -> int:
        return n_outputs if self.task == "classification" else 1

    def init_params(self, keys, n_features, n_outputs):
        C = self._n_scores(n_outputs)
        V = self.init_std * prng.normal(keys, (n_features, self.factor_size, C))
        return {
            "W": torch.zeros((keys.shape[0], n_features + 1, C),
                             dtype=torch.float32, device=keys.device),
            "V": V,
        }

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        n, d, k = n_rows, n_features, self.factor_size
        C = self._n_scores(n_outputs)
        # forward: two (n, d) @ (d, kC) products + the linear term;
        # backward ~ 2x forward
        return float(self.max_iter * 3 * (4 * n * d * k * C + 2 * n * d * C))

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del device
        k = self.factor_size
        C = self._n_scores(n_outputs)
        # the (n, k, C) XV and X²V² activations and their adjoints, the
        # (n, C) scores and probabilities, the weights; the shared X² once
        return float(
            4 * (3 * 2 * n_rows * k * C + 2 * n_rows * C + 2 * n_rows)
        )

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        k = self.factor_size
        C = self._n_scores(n_outputs)
        return float(
            3 * (4 * chunk_rows * n_features * k * C
                 + 2 * chunk_rows * n_features * C)
        )

    def _raw_scores(self, params, X):
        """``(R, n, C)`` scores: the linear term plus the factorized
        pairwise term."""
        X = X.to(torch.float32)
        W, V = params["W"], params["V"]
        R, d, k, C = V.shape
        Vf = V.reshape(R, d, k * C)
        with fp32_matmul():
            lin = X @ W[:, :-1] + W[:, -1:]                     # (R, n, C)
            XV = (X @ Vf).unflatten(-1, (k, C))                 # (R, n, k, C)
            X2V2 = ((X * X) @ (Vf * Vf)).unflatten(-1, (k, C))
        return lin + 0.5 * (XV * XV - X2V2).sum(dim=-2)

    def penalty(self, params):
        return 0.5 * self.l2 * ((params["W"][:, :-1] ** 2).sum(dim=(1, 2))
                                + (params["V"] ** 2).sum(dim=(1, 2, 3)))

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None):
        del keys, prepared
        w = sample_weight.to(torch.float32)
        # floor: all-zero bootstrap draws must stay finite
        w_sum = torch.clamp_min(maybe_psum(w.sum(dim=-1)), 1e-12)   # (R,)
        p = {k: v.clone() for k, v in params.items()}
        opt = Adam(p, self.lr)
        losses = []
        for _ in range(self.max_iter):
            q = {k: v.detach().requires_grad_() for k, v in p.items()}
            with torch.enable_grad(), fp32_matmul():
                local = (w * self.row_loss(q, X, y)).sum(dim=-1) / w_sum
                g = dict(zip(q, torch.autograd.grad(local.sum(),
                                                    list(q.values()))))
                pen = self.penalty(q)
                g_pen = torch.autograd.grad(pen.sum(), list(q.values()))
            # the penalty's gradient by autograd of penalty() itself, added
            # to the data's, as the JAX learner adds them
            g = {k: maybe_psum(g[k]) + gp for k, gp in zip(q, g_pen)}
            losses.append(maybe_psum(local.detach()) + pen.detach())
            opt.step(p, g)
        with torch.no_grad():
            final = maybe_psum((w * self.row_loss(p, X, y)).sum(dim=-1)) \
                / w_sum + self.penalty(p)
        return p, {"loss": final, "loss_curve": torch.stack(losses, dim=1)}


class FMClassifier(_FMBase):
    """Multinomial factorization-machine classifier: a softmax NLL over
    C FM score columns."""

    task = "classification"

    def predict_scores(self, params, X):
        return self._raw_scores(params, X)

    def row_loss(self, params, X, y):
        logp = torch.log_softmax(self._raw_scores(params, X), dim=-1)
        idx = y.long().view(1, -1, 1).expand(logp.shape[0], -1, 1)
        return -logp.gather(-1, idx)[..., 0]


class FMRegressor(_FMBase):
    """Factorization-machine regressor (half squared loss)."""

    task = "regression"

    def predict_scores(self, params, X):
        return self._raw_scores(params, X)[..., 0]

    def row_loss(self, params, X, y):
        resid = self.predict_scores(params, X) - y.to(torch.float32)
        return 0.5 * resid * resid
