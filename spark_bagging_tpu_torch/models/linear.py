"""Weighted linear (ridge) regression by the normal equations.

The port of the JAX package's ``models/linear.py``, batched over a
leading replica axis: every replica of a chunk solves its weighted ridge
normal equations

    (X^T W X + l2 * sum(w) * diag(1, ..., 1, 1e-8)) beta = X^T W y

(the mean-loss parameterization; the bias is penalized only by a
jitter) with one batched Gram product and one batched LU solve with
partial pivoting. The products run in float32 with TF32 off
(ops/precision.py) whatever ``precision`` says; the name is kept for
parity with the JAX signature. The Gram is a plain batched product, as
in the JAX package, where no Pallas kernel computes it. On a data mesh
the Gram, the right-hand side and the weight total sum over the row
shards (``axis_name``), so every shard solves the global system.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.models.base import BaseLearner, augment_bias
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

_BIAS_JITTER = 1e-8
# floor on a replica's weight total, and the total at or below which its
# draw counts as empty (beta = 0), as in the JAX package
_W_SUM_FLOOR = 1e-12
_EMPTY_W_SUM = 2e-12


def _linear(X: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``X beta[:-1] + beta[-1]`` per replica, ``(R, n)``, from a shared
    ``(n, d)`` or a per-replica ``(R, n, d)`` X and ``beta (R, d + 1)``."""
    w, b = beta[:, :-1], beta[:, -1:]
    with fp32_matmul():
        if X.dim() == 2:
            return (X.to(torch.float32) @ w.t()).t() + b
        return torch.bmm(X.to(torch.float32), w[..., None])[..., 0] + b


class LinearRegression(BaseLearner):
    """Weighted least squares with an L2 penalty (bias unpenalized)."""

    task = "regression"
    streamable = True
    data_axis_ready = True

    def __init__(self, l2: float = 1e-6, precision: str = "highest"):
        self.l2 = l2
        self.precision = precision

    def init_params(self, keys, n_features, n_outputs):
        del n_outputs  # the closed-form solver ignores the init
        return {"beta": torch.zeros((keys.shape[0], n_features + 1),
                                    dtype=torch.float32, device=keys.device)}

    def predict_scores(self, params, X):
        return _linear(X, params["beta"])

    def linear_beta(self, params):
        """Prediction is linear in beta, so a bagged mean of replicas is
        one model with the (subspace-scattered) mean coefficients:
        ``BaggingRegressor``'s exact host-side predict path."""
        return params["beta"]

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        del n_outputs
        n, d = n_rows, n_features + 1
        # Gram matmul + right-hand side + the solve + the residual pass
        return float(2 * n * d * d + 4 * n * d + d**3 / 3)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del n_outputs, device
        # the bias-augmented X and the w-scaled copy, the per-replica
        # subspace gather, the weights and the residuals: (n, d+1) x 3
        # and (n,) x 2 float32
        return float(4 * n_rows * (3 * (n_features + 1) + 2))

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        del n_outputs  # scalar output
        return float(6 * chunk_rows * (n_features + 1))

    def row_loss(self, params, X, y):
        """Half squared error per replica and row, ``(R, n)``."""
        return 0.5 * (self.predict_scores(params, X) - y) ** 2

    def penalty(self, params):
        """``0.5 l2 |beta[:-1]|^2`` per replica, ``(R,)``."""
        return 0.5 * self.l2 * (params["beta"][:, :-1] ** 2).sum(dim=-1)

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del params, keys, prepared  # closed form; nothing precomputed
        gram_op_dtype(self.precision)  # reject an unknown name up front
        Xb = augment_bias(X.to(torch.float32))   # (n, d) or (R, n, d)
        y = y.to(torch.float32)
        w = sample_weight.to(torch.float32)      # (R, n)
        d = Xb.shape[-1]
        # an all-zero draw would solve a 0-matrix: with w = 0 the
        # right-hand side is 0 too, and the floor keeps it finite
        # summed over the data shards (axis_name), so every shard solves
        # the same system and takes the same empty-draw branch
        w_sum = torch.clamp_min(maybe_psum(w.sum(dim=-1), axis_name),
                                _W_SUM_FLOOR)
        with fp32_matmul():
            Xw = Xb * w[..., None]                           # (R, n, d)
            XwT = Xw.transpose(-1, -2)
            A = maybe_psum(XwT @ Xb, axis_name)               # (R, d, d)
            b = maybe_psum((XwT @ y[:, None])[..., 0], axis_name)  # (R, d)
            pen = torch.full((d,), self.l2, dtype=torch.float32,
                             device=w.device)
            pen[-1] = _BIAS_JITTER
            # LU with partial pivoting, not Cholesky: a near-empty draw
            # leaves A rank-deficient, and rounding can push an
            # eigenvalue below the tiny penalty, where Cholesky fails
            # and LU still solves the nonsingular system. solve_ex, as
            # JAX's solve, returns what LU gives instead of raising
            beta, _ = torch.linalg.solve_ex(
                A + torch.diag(pen) * w_sum[:, None, None], b)
            # an empty draw with l2 = 0 leaves the system exactly
            # singular: zero rows of evidence fit the inert beta = 0
            beta = torch.where(w_sum[:, None] > _EMPTY_W_SUM, beta,
                               torch.zeros_like(beta))
            resid = _linear(X, beta) - y
            mse = maybe_psum((w * resid**2).sum(dim=-1), axis_name) / w_sum
        return ({"beta": beta},
                {"loss": mse, "loss_curve": mse[:, None]})

