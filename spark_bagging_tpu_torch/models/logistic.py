"""Weighted multinomial logistic regression: damped Newton steps or Adam.

The port of the JAX package's headline learner, batched over a leading
replica axis: every replica of a chunk takes its Newton steps together,
with one Cholesky factorization per replica. ``solver="adam"`` takes
``max_iter`` full-batch Adam steps instead (``optim.Adam``, optax's
arithmetic), one ``autograd`` call giving every replica's gradient, for
problems too wide for a ``(C·d)²`` Hessian.

Hessian assemblies (``hessian_impl``), all exact multinomial Newton:

- ``"blocked"``: the C(C+1)/2 upper-triangle blocks ``X^T diag(s) X``
  as one batched matmul each, in plain torch;
- ``"packed"``: the same blocks from one ``(d, n) @ (n, P·d)`` product
  of X with its C(C+1)/2 scaled copies side by side;
- ``"fused"``: the cross term ``-V^T V`` of ``V[n, (c, i)] = sqrt(w_n)
  p_nc x_ni`` as one ``(C·d, n) @ (n, C·d)`` product, plus the block
  diagonal of the per-class weighted Grams;
- ``"pallas"``: the blocks from the scaled-Gram kernel (ops/gram.py:
  CUDA on the card, its plain version on the CPU). The name is the JAX
  package's, so a JAX configuration carries across.

"auto" resolves as in the JAX package: "blocked" up to C = 8 classes,
"fused" beyond. Every product but the kernel's runs in float32 with
TF32 off, whatever ``precision`` says.
"""

from __future__ import annotations

import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.models.base import (
    Aux,
    BaseLearner,
    Params,
    PooledStartMixin,
    augment_bias,
)
from spark_bagging_tpu_torch.ops.gram import (
    launch_bytes,
    scaled_grams,
    scratch_bytes,
)
from spark_bagging_tpu_torch.ops.precision import fp32_matmul, gram_op_dtype
from spark_bagging_tpu_torch.ops.reduce import maybe_psum
from spark_bagging_tpu_torch.optim import Adam

_BIAS_JITTER = 1e-6  # keeps the softmax gauge direction solvable
# Levenberg-style damping added to the Hessian diagonal at solve time
# only; the gradient stays exact, so the optimum is unchanged.
_SOLVER_DAMPING = 1e-3
_HESSIAN_IMPLS = ("auto", "blocked", "fused", "packed", "pallas")


class LogisticRegression(PooledStartMixin, BaseLearner):
    """Weighted multinomial logistic regression with L2 penalty.

    ``precision`` ("highest"/"float32" or "high"/"default") sets the
    scaled-Gram kernel's operand type (ops/precision.py); all other
    matmuls run in float32.
    """

    task = "classification"
    streamable = True
    # predict_scores is augment_bias(X) @ W: the soft vote takes the
    # soft-vote kernel on the card
    linear_softmax_weights = "W"

    def __init__(
        self,
        l2: float = 1e-3,
        max_iter: int = 15,
        solver: str = "newton",
        lr: float = 0.1,
        precision: str = "highest",
        row_tile: int | None = None,
        hessian_impl: str = "auto",
        init: str = "pooled",
        pooled_iter: int = 5,
    ):
        self.l2 = l2
        self.max_iter = max_iter
        self.solver = solver
        self.lr = lr
        self.precision = precision
        self.validate_init(init)
        self.init = init
        self.pooled_iter = pooled_iter
        if hessian_impl not in _HESSIAN_IMPLS:
            raise ValueError(
                "hessian_impl must be auto|blocked|fused|packed|pallas, "
                f"got {hessian_impl!r}"
            )
        self.hessian_impl = hessian_impl
        # row_tile=t accumulates loss, gradient and Hessian over t-row
        # slices, bounding the per-replica temporaries at (t, C) and
        # (t, P); None = one pass over all rows.
        self.row_tile = row_tile

    def init_params(self, keys, n_features, n_outputs):
        # zero init: uniform probabilities, Newton's best start
        return {"W": torch.zeros(
            (keys.shape[0], n_features + 1, n_outputs),
            dtype=torch.float32, device=keys.device,
        )}

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        n, d, C = n_rows, n_features + 1, n_outputs
        if self.solver != "newton":
            return float(self.max_iter * 6 * n * d * C)
        if self._resolved_hessian(C) == "fused":
            hessian = 2 * n * (C * d) ** 2 + 2 * n * C * d * d
        else:
            hessian = C * (C + 1) * n * d * d
        per_iter = 4 * n * d * C + hessian + (C * d) ** 3 / 3
        return float(self.max_iter * per_iter)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        # The port's eager temporaries per replica: logits, log-probs,
        # probs and the weighted residual at (rows, C), the weights, the
        # (rows, P) scale matrix S and its factor, the blocked path's
        # scaled copy of X or the kernel's Grams and row-split partials,
        # and the (C·d)² Hessian with its factor and the solve's copy.
        C, d = n_outputs, n_features + 1
        if self.solver == "adam":
            # full batch, never row-tiled: the logits, log-probs and their
            # adjoints at (n, C), the weights, and W with Adam's moments
            return float(4.0 * (4 * n_rows * C + 2 * n_rows) + 12.0 * d * C)
        rows = min(self.row_tile or n_rows, n_rows)
        P = C * (C + 1) // 2
        # The wide operands of "fused" (V, and the per-class scaled X of
        # its block diagonal, each (rows, C·d)) and "packed" (the (rows,
        # P·d) scaled copies) are per-replica temporaries too.
        base = 4.0 * (4 * rows * C + 2 * n_rows + 2 * rows * P)
        impl = self._resolved_hessian(C)
        if impl == "pallas":
            base += launch_bytes(rows, d, P)
        elif impl == "fused":
            base += 2 * 4.0 * rows * C * d
        elif impl == "packed":
            base += 4.0 * rows * P * d
        else:
            base += 4.0 * rows * d
        base += 3 * 4.0 * (C * d) ** 2
        return float(base)

    def _gram_scratch_bytes(self, n_rows, n_features):
        """The scaled-Gram launch's images of one X (``ops/gram.py``
        ``scratch_bytes``), where the Newton step launches the kernel."""
        if self.solver == "adam" or self.hessian_impl != "pallas":
            return 0.0
        rows = min(self.row_tile or n_rows, n_rows)
        return scratch_bytes(rows, n_features + 1,
                             gram_op_dtype(self.precision))

    def prepared_bytes(self, n_rows, n_features, device=None):
        # the shared X's images: one set a launch, whatever the chunk
        return self._gram_scratch_bytes(n_rows, n_features)

    def subspace_gather_bytes(self, n_rows, n_subspace, device=None):
        # a gathered subspace gives each replica its own X, and the
        # launch an image set for each
        return (super().subspace_gather_bytes(n_rows, n_subspace, device)
                + self._gram_scratch_bytes(n_rows, n_subspace))

    def predict_scores(self, params, X):
        with fp32_matmul():
            return augment_bias(X.to(torch.float32)) @ params["W"]

    # -- the streaming contract (streaming.py) ---------------------------

    def row_loss(self, params, X, y):
        """Softmax NLL per replica and row, ``(R, n)``."""
        return self._nll_from_scores(self.predict_scores(params, X),
                                     y.long())[0]

    def penalty(self, params):
        return self._penalty(params["W"])

    def sgd_step_flops(self, chunk_rows, n_features, n_outputs):
        # one (n, d+1) @ (d+1, C) forward; x3 for forward and backward
        return float(6 * chunk_rows * (n_features + 1) * n_outputs)

    # ------------------------------------------------------------------

    def _penalty(self, W):
        return 0.5 * self.l2 * (W[..., :-1, :] ** 2).sum(dim=(-2, -1))

    def _penalty_grad(self, W):
        g = self.l2 * W
        g[..., -1, :] = 0.0  # bias unpenalized
        return g

    @staticmethod
    def _nll_from_scores(scores, y):
        """(per-row NLL, log-probs): THE softmax-NLL definition, used by
        every loss and gradient site. ``scores`` ``(R, n, C)``, ``y`` ``(n,)``."""
        logp = torch.log_softmax(scores, dim=-1)
        idx = y.view(1, -1, 1).expand(*logp.shape[:-1], 1)
        return -logp.gather(-1, idx)[..., 0], logp

    def _global_loss(self, W, Xb, y, w, w_sum, tiles, axis_name=None):
        """Weighted mean NLL + penalty, ``(R,)``."""
        local = 0.0
        for sl in tiles:
            nll, _ = self._nll_from_scores(Xb[..., sl, :] @ W, y[sl])
            local = local + (w[:, sl] * nll).sum(dim=-1)
        return maybe_psum(local, axis_name) / w_sum + self._penalty(W)

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del keys, prepared  # deterministic solvers; no precomputation
        if self.solver not in ("newton", "adam"):
            raise ValueError(f"unknown solver {self.solver!r}")
        Xb = augment_bias(X.to(torch.float32))
        w = sample_weight.to(torch.float32)
        # floor: all-zero bootstrap draws must stay finite
        w_sum = torch.clamp_min(maybe_psum(w.sum(dim=-1), axis_name), 1e-12)
        with fp32_matmul():
            if self.solver == "adam":
                return self._fit_adam(params, Xb, y.long(), w, w_sum,
                                      axis_name)
            return self._fit_newton(params, Xb, y.long(), w, w_sum,
                                    axis_name)

    # -- Adam ------------------------------------------------------------

    def _fit_adam(self, params, Xb, y, w, w_sum,
                  axis_name=None) -> tuple[Params, Aux]:
        """``max_iter`` full-batch Adam steps on each replica's weighted
        mean NLL, the penalty's gradient added to the data's, as the JAX
        learner forms it; the curve holds each step's loss before it. On
        a data shard the local loss is over the global weight total and
        its gradient sums over the shards."""
        p = {"W": params["W"].clone()}
        opt = Adam(p, self.lr)
        losses = []
        for _ in range(self.max_iter):
            Wg = p["W"].detach().requires_grad_()
            with torch.enable_grad(), fp32_matmul():
                nll, _ = self._nll_from_scores(Xb @ Wg, y)
                local = (w * nll).sum(dim=-1) / w_sum            # (R,)
                (g,) = torch.autograd.grad(local.sum(), [Wg])
            W = p["W"]
            g = maybe_psum(g, axis_name)
            losses.append(maybe_psum(local.detach(), axis_name)
                          + self._penalty(W))
            opt.step(p, {"W": g + self._penalty_grad(W)})
        W = p["W"]
        final = self._global_loss(W, Xb, y, w, w_sum,
                                  self._row_tiles(Xb.shape[-2]), axis_name)
        curve = (torch.stack(losses, dim=1) if losses
                 else torch.zeros((W.shape[0], 0), device=W.device))
        return {"W": W}, {"loss": final, "loss_curve": curve}

    # -- Newton --------------------------------------------------------

    def _resolved_hessian(self, C: int) -> str:
        if self.hessian_impl not in _HESSIAN_IMPLS:
            # re-validate: set_params() bypasses __init__
            raise ValueError(
                "hessian_impl must be auto|blocked|fused|packed|pallas, "
                f"got {self.hessian_impl!r}"
            )
        if self.hessian_impl != "auto":
            return self.hessian_impl
        return "fused" if C > 8 else "blocked"

    def _newton_stats(self, W, Xt, yt, wt, C, impl):
        """Un-normalized (Σw·nll, data gradient, data Hessian) of one row
        block, each with a leading replica axis."""
        nll, logp = self._nll_from_scores(Xt @ W, yt)
        loss_sum = (wt * nll).sum(dim=-1)
        P = logp.exp()
        Y = torch.nn.functional.one_hot(yt, C).to(torch.float32)
        G = Xt.transpose(-1, -2) @ ((P - Y) * wt[..., None])
        # H_cc' = X^T diag(w·p_c·(δ_cc' − p_c')) X, for c <= c'
        if impl == "fused":
            return loss_sum, G, _fused_hessian(Xt, P, wt)
        ci, cpi = _pairs(C, W.device)
        delta = (ci == cpi).to(torch.float32)
        S = wt[..., None] * P[..., ci] * (delta - P[..., cpi])  # (R, t, P)
        if impl == "pallas":
            grams = scaled_grams(
                Xt.contiguous(), S.contiguous(),
                op_dtype=gram_op_dtype(self.precision),
            )
        elif impl == "packed":
            # the P scaled copies of X side by side: one (d, t) @ (t, P·d)
            # product a replica computes every block
            R, t, n_pairs = S.shape
            d = Xt.shape[-1]
            rhs = (Xt[..., :, None, :] * S[..., None]).reshape(R, t, -1)
            grams = (Xt.transpose(-1, -2) @ rhs).reshape(
                R, d, n_pairs, d).transpose(1, 2)
        else:
            grams = torch.stack([
                (Xt * S[..., k, None]).transpose(-1, -2) @ Xt
                for k in range(S.shape[-1])
            ], dim=1)
        return loss_sum, G, _assemble_hessian(grams, C)

    def _row_tiles(self, n: int) -> list[slice]:
        """Row slices of at most ``row_tile`` rows (one slice when None)."""
        tile = self.row_tile
        if tile is None or n <= tile:
            return [slice(0, n)]
        return [slice(s, min(s + tile, n)) for s in range(0, n, tile)]

    def _fit_newton(self, params, Xb, y, w, w_sum,
                    axis_name=None) -> tuple[Params, Aux]:
        W = params["W"]
        R, d, C = W.shape
        impl = self._resolved_hessian(C)
        gram_op_dtype(self.precision)  # reject an unknown name up front
        tiles = self._row_tiles(Xb.shape[-2])
        # damping diagonal in (c, i) layout: l2 on coefficients, jitter
        # on bias entries
        pen = torch.full((d,), self.l2, dtype=torch.float32, device=W.device)
        pen[-1] = _BIAS_JITTER
        damp = torch.diag(pen.repeat(C) + _SOLVER_DAMPING)
        not_pd = torch.zeros(R, dtype=torch.bool, device=W.device)
        losses = []
        for _ in range(self.max_iter):
            # one damped step: the statistics over the row tiles, the
            # Cholesky solve and the update
            with telemetry.span("newton_step"):
                loss_sum = 0.0
                G = torch.zeros((R, d, C), dtype=torch.float32,
                                device=W.device)
                H = torch.zeros((R, C * d, C * d), dtype=torch.float32,
                                device=W.device)
                for sl in tiles:
                    dl, dG, dH = self._newton_stats(
                        W, Xb[..., sl, :], y[sl], w[:, sl], C, impl
                    )
                    loss_sum, G, H = loss_sum + dl, G + dG, H + dH
                ws = w_sum[:, None, None]
                losses.append(maybe_psum(loss_sum, axis_name) / w_sum
                              + self._penalty(W))
                G = maybe_psum(G, axis_name) / ws + self._penalty_grad(W)
                H = maybe_psum(H, axis_name) / ws + damp
                L, info = torch.linalg.cholesky_ex(H)
                not_pd |= info != 0
                g = G.transpose(-1, -2).reshape(R, C * d, 1)
                delta = torch.cholesky_solve(g, L)
                W = W - delta.reshape(R, C, d).transpose(-1, -2)
        if bool(not_pd.any()):
            raise FloatingPointError(
                "damped Newton Hessian is not positive definite for "
                f"replicas {not_pd.nonzero().flatten().tolist()[:8]}"
            )
        final = self._global_loss(W, Xb, y, w, w_sum, tiles, axis_name)
        curve = (torch.stack(losses, dim=1) if losses
                 else torch.zeros((R, 0), device=W.device))
        return {"W": W}, {"loss": final, "loss_curve": curve}


def _pairs(C: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Class pairs (c, c') with c <= c', in the order the Hessian
    blocks are stacked: (0,0), (0,1), ..., (0,C-1), (1,1), ..."""
    ci, cpi = zip(*[(c, cp) for c in range(C) for cp in range(c, C)])
    return (torch.tensor(ci, device=device), torch.tensor(cpi, device=device))


def _fused_hessian(Xt: torch.Tensor, P: torch.Tensor,
                   wt: torch.Tensor) -> torch.Tensor:
    """The ``(R, C·d, C·d)`` data Hessian in the ``(c·d + i)`` layout:
    ``w p_c p_c' = (sqrt(w) p_c)(sqrt(w) p_c')``, so the cross term is
    ``-V^T V`` with ``V[n, (c, i)] = sqrt(w_n) p_nc x_ni``, one product a
    replica; the delta term is the block diagonal of the per-class
    weighted Grams ``sum_n x x^T w p_c``."""
    R, t, C = P.shape
    d = Xt.shape[-1]
    xs = Xt * wt.sqrt()[..., None]                         # (R, t, d)
    V = (P[..., :, None] * xs[..., None, :]).reshape(R, t, C * d)
    H = -(V.transpose(-1, -2) @ V)
    del V
    a = (wt[..., None] * P).transpose(-1, -2)              # (R, C, t)
    Xc = Xt[..., None, :, :] if Xt.dim() == 3 else Xt
    D = (Xc * a[..., None]).transpose(-1, -2) @ Xc         # (R, C, d, d)
    Hv = H.view(R, C, d, C, d)
    for c in range(C):
        Hv[:, c, :, c, :] += D[:, c]
    return H


def _assemble_hessian(grams: torch.Tensor, C: int) -> torch.Tensor:
    """``(R, P, d, d)`` upper-triangle blocks -> ``(R, C·d, C·d)`` with
    block (c, c') = block (c', c) = grams[pair(c, c')]."""
    R, _, d, _ = grams.shape
    index = torch.empty((C, C), dtype=torch.long)
    k = 0
    for c in range(C):
        for cp in range(c, C):
            index[c, cp] = index[cp, c] = k
            k += 1
    blocks = grams[:, index.to(grams.device)]  # (R, C, C, d, d)
    return blocks.permute(0, 1, 3, 2, 4).reshape(R, C * d, C * d)
