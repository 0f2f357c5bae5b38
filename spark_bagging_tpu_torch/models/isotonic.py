"""Isotonic regression (Spark ML's ``IsotonicRegression``) by binned
closed-form minimax.

The port of the JAX package's ``models/isotonic.py``, batched over a
leading replica axis. Pool-adjacent-violators is sequential; instead:

1. quantile-bin x (column 0 of X) into ``n_bins`` buckets, edges made
   once a fit by ``prepare`` (the trees' ``_quantile_edges``), and sum
   each replica's weighted (w, w y, w x) a bin: one ``(B, n) @ (n, 3)``
   product of the rows' bin one-hot with the moments;
2. the isotonic fit at bin i is ``max_{j <= i} min_{k >= i} mean(y_j
   .. y_k)``: a ``(B, B)`` table of span means from prefix sums, a
   reversed ``cummin`` over k (``torch.flip`` + ``torch.cummin``) and a
   ``cummax`` over j.

Exact (PAV's answer) wherever every distinct x has a bin of its own;
otherwise isotonic regression on the binned means. Prediction
interpolates linearly between the bins' weighted mean x (``jnp.interp``'s
arithmetic), constant beyond. On a data mesh the edges are the shards'
averaged quantiles and the bin moments and the MSE sum over the row
shards. ``increasing=False`` fits the antitonic
case by flipping the sign of y. Products run in float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.tree import (
    _psum_average_edges,
    _quantile_edges,
)
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

_EPS = 1e-12
# np.spacing(np.finfo(np.float32).eps): where jnp.interp takes a span as 0
_DX_EPS = 2.0**-46


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` per replica: ``x (R, n)`` or ``(n,)``,
    ``xp`` and ``fp`` ``(R, B)`` -> ``(R, n)``; ``fp[0]`` left of
    ``xp[0]``, ``fp[-1]`` right of ``xp[-1]``, ``fp`` at the left end of
    a span no wider than ``_DX_EPS``."""
    R, B = xp.shape
    x = x.expand(R, -1) if x.dim() == 1 else x
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, B - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    dx, df = x1 - x0, f1 - f0
    dx0 = dx.abs() <= _DX_EPS
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    return torch.where(x > xp[:, -1:], fp[:, -1:], f)


class IsotonicRegression(BaseLearner):
    """Monotone single-feature regression on column 0 of X (Spark's
    featuresCol + featureIndex convention)."""

    task = "regression"
    streamable = False  # closed form over bins; no gradient stream

    def __init__(self, n_bins: int = 128, increasing: bool = True):
        if n_bins < 2:
            raise ValueError(f"n_bins must be >= 2, got {n_bins}")
        self.n_bins = n_bins
        self.increasing = increasing

    def init_params(self, keys, n_features, n_outputs):
        del n_features, n_outputs
        zeros = torch.zeros((keys.shape[0], self.n_bins), dtype=torch.float32,
                            device=keys.device)
        return {"centers": zeros, "values": zeros.clone()}

    # -- replica-invariant binning, once a fit --------------------------

    def prepare(self, X, *, row_mask=None, axis_name=None):
        interior, n_valid = _quantile_edges(X.to(torch.float32), row_mask,
                                            self.n_bins)
        # a data mesh's shards average their quantiles (models/tree.py)
        return {"interior": _psum_average_edges(interior, n_valid,
                                                axis_name)}    # (F, B-1)

    def gather_subspace(self, prepared, idx):
        return {"interior": prepared["interior"][idx.long()]}  # (R, k, B-1)

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        del n_features, n_outputs
        B = self.n_bins
        # the bin search and accumulation a row, and the (B, B) table: the
        # JAX package's O(n) count, which does not charge the one-hot
        return float(n_rows * (math.ceil(math.log2(B)) + 4) + 6 * B * B)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        del n_features, n_outputs, device
        B = self.n_bins
        # the rows' (n, B) bin one-hot and (n, 3) moments, the bin
        # indices and the report's predictions; the (B, B) span tables
        return float(4 * n_rows * (B + 8) + 4 * 6 * B * B)

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del params, keys
        B = self.n_bins
        X = X.to(torch.float32)
        x = X[..., 0]                                          # (n,) | (R, n)
        yf = y.to(torch.float32)
        if not self.increasing:
            yf = -yf
        w = sample_weight.to(torch.float32)                    # (R, n)
        R = w.shape[0]
        # the bins' geometry ignores the weights; their statistics do not
        if prepared is None:
            prepared = self.prepare(X if X.dim() == 2 else X[0],
                                    axis_name=axis_name)
        interior = prepared["interior"]
        interior = (interior[0].expand(R, -1) if interior.dim() == 2
                    else interior[:, 0])                       # (R, B-1)
        xr = x.expand(R, -1) if x.dim() == 1 else x
        idx = torch.searchsorted(interior.contiguous(), xr.contiguous(),
                                 right=True)                   # (R, n) in [0, B)
        onehot = torch.nn.functional.one_hot(idx, B).to(torch.float32)
        moments = torch.stack([w, w * yf, w * xr], dim=-1)     # (R, n, 3)
        with fp32_matmul():
            stats = maybe_psum(onehot.transpose(1, 2) @ moments,
                               axis_name)                      # (R, B, 3)
        W, Swy = stats[..., 0], stats[..., 1]
        # centers: each bin's weighted mean x; an empty bin its edges'
        # midpoint (the interpolation's anchor)
        lo = torch.cat([interior[:, :1], interior], dim=1)
        hi = torch.cat([interior, interior[:, -1:]], dim=1)
        centers = torch.where(W > 0, stats[..., 2] / torch.clamp_min(W, _EPS),
                              0.5 * (lo + hi))
        # A[j, k] = mean(y over bins j..k) from prefix sums; an empty span
        # is +inf so the min skips it, a row left +inf is -inf for the max
        zero = torch.zeros((R, 1), dtype=torch.float32, device=w.device)
        cW = torch.cat([zero, torch.cumsum(W, dim=1)], dim=1)
        cS = torch.cat([zero, torch.cumsum(Swy, dim=1)], dim=1)
        Wspan = cW[:, None, 1:] - cW[:, :-1, None]             # (R, B, B)
        Sspan = cS[:, None, 1:] - cS[:, :-1, None]
        A = torch.where(Wspan > 0, Sspan / torch.clamp_min(Wspan, _EPS),
                        math.inf)
        # min over k >= i: the reversed cumulative min along k
        mink = torch.flip(torch.cummin(torch.flip(A, [2]), dim=2).values, [2])
        M = torch.where(torch.isfinite(mink), mink, -math.inf)
        # max over j <= i: the cumulative max along j
        iso = torch.cummax(M, dim=1).values
        values = torch.diagonal(iso, dim1=1, dim2=2)           # (R, B)
        # bins no data reaches: the global mean
        gmean = Swy.sum(dim=1) / torch.clamp_min(W.sum(dim=1), _EPS)
        values = torch.where(torch.isfinite(values), values, gmean[:, None])
        if not self.increasing:
            values = -values
        # the weighted mean squared error, for the report
        pred = interp(xr, centers, values)
        w_sum = maybe_psum(w.sum(dim=-1), axis_name)
        mse = maybe_psum((w * (pred - y.to(torch.float32)) ** 2).sum(dim=-1),
                         axis_name) / torch.clamp_min(w_sum, _EPS)
        return ({"centers": centers, "values": values},
                {"loss": mse, "loss_curve": mse[:, None]})

    def predict_scores(self, params, X):
        """Linear interpolation between the bin centers, constant beyond
        the data's range: ``(R, n)``."""
        return interp(X.to(torch.float32)[..., 0], params["centers"],
                      params["values"])
