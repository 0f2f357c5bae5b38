"""Accelerated-failure-time survival regression (Weibull AFT, Spark ML's
``AFTSurvivalRegression``).

The port of the JAX package's ``models/aft.py``, batched over a leading
replica axis. Survival time T follows a Weibull distribution with
``log T = mu + sigma eps``, ``mu = X beta + b``, eps standard (minimum)
extreme value. With ``z = (log t - mu) / sigma`` and the censor flag
delta (1 = event observed, 0 = right-censored, Spark's censorCol):

    log L_i = delta (z - log sigma) - e^z      (+ a constant)

The fit maximizes each replica's Poisson-weighted log-likelihood over
``(beta, b, log sigma)`` by ``max_iter`` full-batch Adam steps
(``optim.Adam``, optax's arithmetic), one ``autograd`` call giving
every replica's gradient. The censor column is the per-row ``aux``
channel (``uses_aux``): ``BaggingRegressor.fit(X, y, aux=delta)`` or a
streamed column (``fit_stream(aux_col=)``); without it every row is an
observed event. ``predict_scores`` is ``e^mu`` (Spark's prediction),
``predict_quantiles`` the Weibull quantiles (Spark's quantilesCol).
Products run in float32 with TF32 off.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch.models.base import BaseLearner, augment_bias
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum, maybe_psum_many
from spark_bagging_tpu_torch.optim import Adam

_EPS = 1e-8


def _mu(params, X):
    """``Xb @ beta`` per replica, ``(R, n)``."""
    Xb = augment_bias(X.to(torch.float32))
    with fp32_matmul():
        return (Xb @ params["beta"][..., None])[..., 0]


class AFTSurvivalRegression(BaseLearner):
    """Weibull accelerated-failure-time regressor with right censoring:
    ``l2`` penalizes beta (never the bias or log sigma); ``precision``
    is kept for the JAX signature (every product is float32)."""

    task = "regression"
    # streams through the SGD engine with the censor column named by
    # fit_stream's aux_col; without it every row counts as observed
    streamable = True
    uses_aux = True

    def __init__(
        self,
        max_iter: int = 200,
        lr: float = 0.05,
        l2: float = 1e-4,
        precision: str = "high",
    ):
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        gram_op_dtype(precision)  # reject an unknown name up front
        self.max_iter = max_iter
        self.lr = lr
        self.l2 = l2
        self.precision = precision

    def init_params(self, keys, n_features, n_outputs):
        del n_outputs  # zero init, scalar output
        R, dev = keys.shape[0], keys.device
        return {
            "beta": torch.zeros((R, n_features + 1), dtype=torch.float32,
                                device=dev),
            "log_sigma": torch.zeros((R,), dtype=torch.float32, device=dev),
        }

    def predict_scores(self, params, X):
        """The predicted survival time ``e^mu``, ``(R, n)``."""
        return torch.exp(_mu(params, X))

    def predict_quantiles(self, params, X, probs):
        """Weibull quantiles ``t_p = exp(mu + sigma log(-log(1 - p)))``
        for each p in ``probs``: ``(R, n, len(probs))``."""
        mu = _mu(params, X)
        sigma = torch.exp(params["log_sigma"])
        p = torch.as_tensor(probs, dtype=torch.float32, device=mu.device)
        return torch.exp(mu[..., None]
                         + sigma[:, None, None]
                         * torch.log(-torch.log1p(-p))[None, None, :])

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        del n_outputs
        n, d = n_rows, n_features + 1
        # forward (n, d) @ (d,) and backward ~ 2x, a step
        return float(self.max_iter * 6 * n * d)

    def _nll_rows(self, params, X, y, delta):
        """The per-row negative Weibull AFT log-likelihood ``(R, n)``."""
        logt = torch.log(torch.clamp_min(y.to(torch.float32), _EPS))
        log_sigma = params["log_sigma"][:, None]
        z = (logt - _mu(params, X)) / torch.exp(log_sigma)
        return -(delta * (z - log_sigma) - torch.exp(z))

    # -- the streaming contract (with the aux channel) ------------------

    def row_loss(self, params, X, y, aux=None):
        delta = (torch.ones_like(y, dtype=torch.float32) if aux is None
                 else aux.to(torch.float32))
        return self._nll_rows(params, X, y, delta)

    def penalty(self, params):
        return 0.5 * self.l2 * (params["beta"][:, :-1] ** 2).sum(dim=-1)

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        del n_outputs
        return float(6 * chunk_rows * (n_features + 1))

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del n_outputs, device
        # the bias-augmented X (n, d+1) and the working vectors (z, the
        # log-likelihood, weights, flags, their adjoints) at (n,)
        return float(4 * n_rows * (n_features + 1) + 24 * n_rows)

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            aux=None, axis_name=None):
        del keys, prepared
        X = X.to(torch.float32)
        w = sample_weight.to(torch.float32)
        # delta: 1 = event observed, 0 = right-censored; None: observed
        delta = torch.ones_like(w) if aux is None else aux.to(torch.float32)
        denom = torch.clamp_min(maybe_psum(w.sum(dim=-1), axis_name), _EPS)

        def data(p):
            """This shard's weighted NLL over the global weight sum."""
            return (w * self._nll_rows(p, X, y, delta)).sum(dim=-1) / denom

        p = {k: v.clone() for k, v in params.items()}
        opt = Adam(p, self.lr)
        losses = []
        for _ in range(self.max_iter):
            q = {k: v.detach().requires_grad_() for k, v in p.items()}
            with torch.enable_grad(), fp32_matmul():
                # the data term's gradient sums over the row shards; the
                # penalty's is every shard's own
                local = data(q)
                g_data = torch.autograd.grad(local.sum(), list(q.values()))
                pen = self.penalty(q)
                g_pen = torch.autograd.grad(pen.sum(), list(q.values()),
                                            allow_unused=True)
            loss, *g_data = maybe_psum_many([local.detach(), *g_data],
                                            axis_name)
            grads = [gd if gp is None else gd + gp
                     for gd, gp in zip(g_data, g_pen)]
            loss = loss + pen.detach()
            losses.append(loss)
            opt.step(p, dict(zip(q, grads)))
        with torch.no_grad():
            final = maybe_psum(data(p), axis_name) + self.penalty(p)
        return p, {"loss": final, "loss_curve": torch.stack(losses, dim=1)}
