"""Weighted linear SVM (squared hinge, one-vs-rest).

The port of the JAX package's ``models/svm.py``, batched over a leading
replica axis. The squared hinge is smooth, so damped Newton applies;
one-vs-rest decouples the classes, so the Hessian is block-diagonal: C
independent ``(d, d)`` systems a replica, each the indicator-weighted
Gram ``Xb^T diag(2 w [margin < 1]) Xb`` (one batched product a class),
solved by a batched Cholesky. A step-halving line search over
``_STEPS`` (0 among them) keeps the loss from rising: a full step can
overshoot the active set's boundary and cycle.

The Grams are plain float32 products with TF32 off, as in the JAX
package, where no Pallas kernel computes them (routing them through the
scaled-Gram kernel is a later candidate, ROADMAP Queue B).
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.models.base import (
    BaseLearner,
    PooledStartMixin,
    augment_bias,
)
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

# solve-time Levenberg damping: keeps a class's Gram positive definite
# when it has no active rows; the gradient stays exact. It also covers
# the unpenalized bias row.
_SOLVER_DAMPING = 1e-3
# the line search's candidate step sizes, 0 as the floor
_STEPS = (1.0, 0.5, 0.25, 0.0)


def _margins(Xb: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``Xb @ W`` per replica, ``(R, n, C)``."""
    with fp32_matmul():
        return Xb @ W


class LinearSVC(PooledStartMixin, BaseLearner):
    """L2-regularized squared-hinge linear classifier (one-vs-rest):
    ``l2`` the penalty (sklearn's ``C`` ~ ``1 / (l2 n)``), ``max_iter``
    Newton iterations, ``precision`` kept for the JAX signature (every
    product is float32)."""

    task = "classification"
    streamable = True

    def __init__(
        self,
        l2: float = 1e-3,
        max_iter: int = 8,
        precision: str = "high",
        init: str = "zeros",
        pooled_iter: int = 5,
    ):
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        gram_op_dtype(precision)  # reject an unknown name up front
        self.l2 = l2
        self.max_iter = max_iter
        self.precision = precision
        # convex, so the pooled warm start applies; fit_stream has no
        # pooled pre-pass and starts from zeros
        self.validate_init(init)
        self.init = init
        self.pooled_iter = pooled_iter

    def init_params(self, keys, n_features, n_outputs):
        return {"W": torch.zeros((keys.shape[0], n_features + 1, n_outputs),
                                 dtype=torch.float32, device=keys.device)}

    def predict_scores(self, params, X):
        """One-vs-rest margins ``(R, n, C)``: the argmax is the class;
        the soft vote's softmax of them is a monotone surrogate."""
        return _margins(augment_bias(X.to(torch.float32)), params["W"])

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        n, d, C = n_rows, n_features + 1, n_outputs
        # margins, gradient and the line search's one extra product; C
        # indicator-weighted (d, d) Grams; C Cholesky solves
        per_iter = 6 * n * d * C + 2 * n * d * d * C + C * d**3 / 3
        return float(self.max_iter * per_iter)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del device
        C, d = n_outputs, n_features + 1
        # the bias-augmented X and one class's weighted copy (n, d); the
        # margins, hinge terms, weights and the line search's direction
        # and candidates at (n, C); the (C, d, d) Grams, their factors
        return float(4 * (2 * n_rows * d + 6 * n_rows * C + n_rows)
                     + 3 * 4.0 * C * d * d)

    # -- the streaming contract (streaming.py) ---------------------------

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        return float(6 * chunk_rows * (n_features + 1) * n_outputs)

    @staticmethod
    def _signs(y, C, device):
        """``T = 2 onehot(y) - 1``: +1 for a row's class, -1 elsewhere."""
        onehot = torch.nn.functional.one_hot(y.long(), C).to(torch.float32)
        return (2.0 * onehot - 1.0).to(device)

    def row_loss(self, params, X, y):
        """The squared hinge summed over classes, ``(R, n)``."""
        M = self.predict_scores(params, X)
        T = self._signs(y, M.shape[-1], M.device)
        a = torch.relu(1.0 - T * M)
        return (a * a).sum(dim=-1)

    def penalty(self, params):
        return 0.5 * self.l2 * (params["W"][:, :-1] ** 2).sum(dim=(1, 2))

    # ------------------------------------------------------------------

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del keys, prepared  # deterministic solver; no precomputation
        Xb = augment_bias(X.to(torch.float32))
        w = sample_weight.to(torch.float32)
        # floor: all-zero bootstrap draws must stay finite
        w_sum = torch.clamp_min(maybe_psum(w.sum(dim=-1), axis_name),
                                1e-12)                               # (R,)
        W = params["W"]
        R, d, C = W.shape
        T = self._signs(y, C, W.device)                            # (n, C)
        # L2 on the feature rows only; the damping conditions the bias
        pen = torch.full((d,), self.l2, dtype=torch.float32, device=W.device)
        pen[-1] = 0.0
        eye = torch.eye(d, dtype=torch.float32, device=W.device)
        steps = torch.tensor(_STEPS, dtype=torch.float32, device=W.device)

        def reg(Wc):
            return 0.5 * self.l2 * (Wc[..., :-1, :] ** 2).sum(dim=(-2, -1))

        def data_loss(M):
            """Weighted squared-hinge mass from the margins, ``(R,)``."""
            a = torch.relu(1.0 - T * M)
            return maybe_psum((w[..., None] * a * a).sum(dim=(-2, -1)),
                              axis_name) / w_sum

        losses = []
        with fp32_matmul():
            for _ in range(self.max_iter):
                M = Xb @ W                                         # (R, n, C)
                a = torch.relu(1.0 - T * M)
                losses.append(data_loss(M) + reg(W))
                # d/dW sum w a^2 = Xb^T (-2 w T a); the penalty outside
                G = maybe_psum(Xb.transpose(-1, -2)
                               @ (-2.0 * w[..., None] * T * a), axis_name) \
                    / w_sum[:, None, None]
                G = G + self.l2 * torch.cat(
                    [W[:, :-1], torch.zeros_like(W[:, -1:])], dim=1)
                # per class: Xb^T diag(2 w [a > 0]) Xb, (R, C, d, d)
                active = (a > 0).to(torch.float32) * (2.0 * w[..., None])
                H = torch.stack([
                    (Xb * active[..., c, None]).transpose(-1, -2) @ Xb
                    for c in range(C)], dim=1) / w_sum[:, None, None, None]
                H = maybe_psum(H, axis_name) + torch.diag(pen) \
                    + _SOLVER_DAMPING * eye
                L, _ = torch.linalg.cholesky_ex(H)
                delta = torch.cholesky_solve(
                    G.transpose(1, 2)[..., None], L)[..., 0]       # (R, C, d)
                delta = delta.transpose(1, 2)                      # (R, d, C)
                # margins at W - s delta are M - s D: one more product
                # prices every candidate; the first minimum is taken
                D = Xb @ delta
                cand = torch.stack([
                    data_loss(M - s * D) + reg(W - s * delta)
                    for s in _STEPS], dim=1)                       # (R, 4)
                s_best = steps[torch.argmin(cand, dim=1)]
                W = W - s_best[:, None, None] * delta
            final = data_loss(Xb @ W) + reg(W)
        return {"W": W}, {"loss": final,
                          "loss_curve": torch.stack(losses, dim=1)}
