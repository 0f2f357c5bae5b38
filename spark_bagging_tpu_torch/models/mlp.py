"""One-hidden-layer MLP base learners (BASELINE config 4), batched over
a leading replica axis.

The port of the JAX package's ``models/mlp.py``: Adam (``optim.Adam``,
optax's arithmetic) over ``max_iter`` steps, full batch
(``batch_size=None``, exact) or minibatches of ``batch_size`` rows that
each replica draws with ``prng.randint`` from its own step keys
(``prng.split(key, max_iter)``), as the JAX learner does. The Poisson
bootstrap counts weight each row's loss (weighted sum over weight
sum), so rows a replica never drew contribute nothing. On a data mesh
(``axis_name``) the weight sums, the gradients and the losses sum over
the row shards before the update, so every shard takes the same step;
each shard's first layer is still one GEMM over its rows.

Replicas share no parameters, so the gradient of the sum of their
losses is every replica's own gradient: one ``autograd`` call serves
the whole stack. With a shared X (the identity feature subspace) the
first layer of every replica is one GEMM, ``X (n, F) @ W1 (F, R·H)``.

``precision`` keeps the JAX names; every product here is float32 with
TF32 off (ops/precision.py: only the scaled-Gram kernel takes bfloat16
operands). ``"gelu"`` is ``jax.nn.gelu``'s default, the tanh
approximation.

On the CPU the first layer's sum over features runs in one fixed order,
whatever the thread count: two float32 accumulators, fed by fused
multiply-adds from the even and the odd features, then added (the order
XLA's CPU dot takes at these widths). The sign of a pre-activation near
0 decides a ReLU unit's activity for that row, and Adam turns such a
flip in a unit that few rows reach into a step of up to ``lr``: with the
library GEMM's order, one of 16 config-4 replicas drifted 3.5e-4 from
the JAX fit over 50 steps. The backward products stay GEMMs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum, maybe_psum_many
from spark_bagging_tpu_torch.optim import Adam

_EPS = 1e-8

_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


class _FixedOrderFirstLayer(torch.autograd.Function):
    """``X @ W1`` per replica, ``(R, n, H)`` from a shared ``(n, F)`` or a
    per-replica ``(R, n, F)`` X and ``W1 (R, F, H)``, summed over
    features in one fixed order (the module docstring): each fused
    multiply-add is one float64 product and sum rounded to float32 (the
    product is exact). Its gradients are the usual products."""

    @staticmethod
    def forward(ctx, X, W1):
        ctx.save_for_backward(X, W1)
        R, F, H = W1.shape
        # features in pairs, a zero feature padding an odd count (a
        # multiply-add of 0 leaves the sum as it is): accumulator 0 takes
        # the even features, accumulator 1 the odd, one op for both
        pad = F % 2
        X64 = torch.nn.functional.pad(X.to(torch.float64), (0, pad))
        X64 = X64.unflatten(-1, (-1, 2))[..., None]        # (.., n, P, 2, 1)
        W64 = torch.nn.functional.pad(W1.to(torch.float64), (0, 0, 0, pad))
        W64 = W64.unflatten(1, (-1, 2))[:, None]           # (R, 1, P, 2, H)
        n = X.shape[-2]
        acc = torch.zeros((R, n, 2, H), dtype=torch.float64, device=X.device)
        acc32 = torch.empty((R, n, 2, H), dtype=torch.float32,
                            device=X.device)
        for j in range(X64.shape[-3]):
            acc.addcmul_(X64[..., j, :, :], W64[:, :, j])
            acc32.copy_(acc)                               # one rounding
            acc.copy_(acc32)
        return acc32[:, :, 0] + acc32[:, :, 1]

    @staticmethod
    def backward(ctx, g):
        X, W1 = ctx.saved_tensors
        gX = gW = None
        with fp32_matmul():
            if ctx.needs_input_grad[0]:
                gX = g @ W1.transpose(-1, -2)
                if X.dim() == 2:
                    gX = gX.sum(dim=0)
            if ctx.needs_input_grad[1]:
                Xr = X if X.dim() == 3 else X.expand(W1.shape[0], *X.shape)
                gW = Xr.transpose(-1, -2) @ g
        return gX, gW


def _per_replica(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An ``(R,)`` vector shaped to broadcast against ``like`` ``(R, ...)``."""
    return v.view(-1, *([1] * (like.dim() - 1)))


class _MLPBase(BaseLearner):
    """Shared forward and training loop of the classifier and regressor."""

    streamable = True

    def __init__(
        self,
        hidden: int = 64,
        max_iter: int = 200,
        batch_size: int | None = None,
        lr: float = 1e-3,
        l2: float = 1e-4,
        activation: str = "relu",
        precision: str = "high",
    ):
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)}, "
                f"got {activation!r}"
            )
        if hidden < 1:
            raise ValueError(f"hidden must be >= 1, got {hidden}")
        if batch_size is not None and batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1 or None, got {batch_size}"
            )
        gram_op_dtype(precision)  # reject an unknown name up front
        self.hidden = hidden
        self.max_iter = max_iter
        self.batch_size = batch_size
        self.lr = lr
        self.l2 = l2
        self.activation = activation
        self.precision = precision

    def init_params(self, keys, n_features, n_outputs):
        """He-scaled normal weights (``jax.random.normal`` of each
        replica's two split keys), zero biases."""
        R, dev = keys.shape[0], keys.device
        k = prng.split(keys, 2)
        # jnp.sqrt of a weakly typed float: float32
        s1 = float(np.sqrt(np.float32(2.0 / n_features)))
        s2 = float(np.sqrt(np.float32(2.0 / self.hidden)))
        return {
            "W1": prng.normal(k[:, 0], (n_features, self.hidden)) * s1,
            "b1": torch.zeros((R, self.hidden), dtype=torch.float32,
                              device=dev),
            "W2": prng.normal(k[:, 1], (self.hidden, n_outputs)) * s2,
            "b2": torch.zeros((R, n_outputs), dtype=torch.float32,
                              device=dev),
        }

    def _forward(self, params, X):
        """Output ``(R, n, C)`` from a shared ``(n, F)`` or a per-replica
        ``(R, n, F)`` X."""
        W1 = params["W1"]
        R, n_in, H = W1.shape
        with fp32_matmul():
            if X.device.type == "cpu":
                pre = _FixedOrderFirstLayer.apply(X, W1)
            elif X.dim() == 2:
                # every replica's first layer in one GEMM; the (n, R, H)
                # result is viewed as (R, n, H)
                pre = X @ W1.permute(1, 0, 2).reshape(n_in, R * H)
                pre = pre.view(X.shape[0], R, H).transpose(0, 1)
            else:
                pre = torch.bmm(X, W1)
            h = _ACTIVATIONS[self.activation](pre + params["b1"][:, None])
            return torch.bmm(h, params["W2"]) + params["b2"][:, None]

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        b = self.batch_size if self.batch_size is not None else n_rows
        b = min(b, n_rows)
        # forward + backward ~ 3x the two forward matmuls a step
        per_step = 6 * b * (n_features * self.hidden + self.hidden * n_outputs)
        return float(self.max_iter * per_step)

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        return float(
            6 * chunk_rows
            * (n_features * self.hidden + self.hidden * n_outputs)
        )

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del device
        b = min(self.batch_size or n_rows, n_rows)
        # the activations and their adjoints (~3x) on one minibatch,
        # Adam's 3 parameter copies (parameters and 2 moments), the
        # per-replica (b, d) minibatch gather X[idx] and the weights
        return float(
            12 * b * (self.hidden + n_outputs)
            + 12 * (n_features * self.hidden + self.hidden * n_outputs)
            + 4 * b * n_features
            + 4 * n_rows
        )

    def _row_loss(self, params, X, y):
        """Unweighted loss per replica and row ``(R, n)``; per task."""
        raise NotImplementedError

    def _penalty(self, params):
        return (0.5 * self.l2) * ((params["W1"] ** 2).sum(dim=(1, 2))
                                  + (params["W2"] ** 2).sum(dim=(1, 2)))

    # -- the streaming contract (streaming.py) ---------------------------

    def row_loss(self, params, X, y):
        return self._row_loss(params, X.to(torch.float32), y)

    def penalty(self, params):
        return self._penalty(params)

    # -- the fit ---------------------------------------------------------

    def _weighted_grad(self, params, X, y, w, axis_name=None):
        """``(loss, grad)`` of each replica's weighted mean loss plus its
        penalty: the gradient of the weighted loss sum over the weight
        sum, plus the penalty's gradient, as the JAX learner forms it.
        The loss sums, weight sums and gradients sum over ``axis_name``
        (the penalty is every shard's own)."""
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad(), fp32_matmul():
            loss_sum = (w * self._row_loss(p, X, y)).sum(dim=-1)    # (R,)
            grads = dict(zip(p, torch.autograd.grad(loss_sum.sum(),
                                                    list(p.values()))))
            pen = self._penalty(p)
            pen_w1, pen_w2 = torch.autograd.grad(pen.sum(),
                                                 [p["W1"], p["W2"]])
        # one collective a step on a data mesh
        w_sum, loss_sum, *summed = maybe_psum_many(
            [w.sum(dim=-1), loss_sum.detach(), *grads.values()], axis_name)
        grads = dict(zip(grads, summed))
        denom = torch.clamp_min(w_sum, _EPS)
        g = {k: v / _per_replica(denom, v) for k, v in grads.items()}
        g["W1"] += pen_w1
        g["W2"] += pen_w2
        return loss_sum / denom + pen.detach(), g

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del prepared
        X = X.to(torch.float32)
        w = sample_weight.to(torch.float32)
        n = X.shape[-2]
        params = {k: v.clone() for k, v in params.items()}
        opt = Adam(params, self.lr)
        # batch_size >= n is the EXACT full batch: a with-replacement
        # draw of n rows would train on ~63% unique rows a step
        full = self.batch_size is None or self.batch_size >= n
        if not full:
            step_keys = prng.split(keys, self.max_iter)   # (R, T, 2)
            rows = torch.arange(w.shape[0], device=w.device)[:, None]
        curve = []
        for t in range(self.max_iter):
            if full:
                Xb, yb, wb = X, y, w
            else:
                idx = prng.randint(step_keys[:, t], self.batch_size,
                                   0, n).long()           # (R, b)
                Xb = X[idx] if X.dim() == 2 else X[rows, idx]
                yb, wb = y[idx], w.gather(1, idx)
            loss, g = self._weighted_grad(params, Xb, yb, wb, axis_name)
            opt.step(params, g)
            curve.append(loss)
        # the final loss on the full weighted data, for the report
        with torch.no_grad(), fp32_matmul():
            w_sum = maybe_psum(w.sum(dim=-1), axis_name)
            full_loss = (maybe_psum((w * self._row_loss(params, X, y))
                                    .sum(dim=-1), axis_name)
                         / torch.clamp_min(w_sum, _EPS)
                         + self._penalty(params))
        return params, {"loss": full_loss,
                        "loss_curve": torch.stack(curve, dim=1)}


class MLPClassifier(_MLPBase):
    """One-hidden-layer softmax classifier (a 2-layer MLP)."""

    task = "classification"

    def predict_scores(self, params, X):
        return self._forward(params, X.to(torch.float32))

    def _row_loss(self, params, X, y):
        logp = torch.log_softmax(self._forward(params, X), dim=-1)
        idx = y.long()
        idx = (idx.view(1, -1, 1).expand(logp.shape[0], -1, 1)
               if idx.dim() == 1 else idx[..., None])
        return -logp.gather(-1, idx)[..., 0]


class MLPRegressor(_MLPBase):
    """One-hidden-layer regression MLP (squared loss)."""

    task = "regression"

    def init_params(self, keys, n_features, n_outputs):
        del n_outputs  # regression heads are scalar
        return super().init_params(keys, n_features, 1)

    def predict_scores(self, params, X):
        return self._forward(params, X.to(torch.float32))[..., 0]

    def _row_loss(self, params, X, y):
        pred = self._forward(params, X)[..., 0]
        return 0.5 * (pred - y.to(torch.float32)) ** 2
