"""The plain reference of a bag of damped-Newton multinomial logistic
regressions with a pooled start, in float64 torch (TF32 off).

What a fit of ``BaggingClassifier(LogisticRegression(max_iter=m,
init="pooled", pooled_iter=k, l2=l2))`` computes, written from its
definition and worked out again from the inputs alone:

- the pooled start ``W0``: ``k`` Newton steps from zero on every row at
  weight one;
- replica ``r``: ``m`` Newton steps from ``W0`` on its bootstrap counts
  (``reference/threefry.py``), each the step of the weighted mean
  softmax NLL plus ``l2/2 |W[:-1]|^2``: gradient ``X^T (P - Y) w / sum w
  + l2 W`` (bias row unpenalised), Hessian blocks ``X^T diag(w p_c
  (delta_cc' - p_c')) X / sum w`` plus the solver's damping diagonal
  (``damping`` on every entry, ``l2`` on coefficients, ``bias_jitter``
  on the bias: the configuration's ``reference`` block), solved by
  Cholesky;
- the served probability: the mean over replicas of ``softmax([X,
  1] W_r)``.

Numbers compared (each is a gap; lower is better):

- ``w_gap``: over the sampled replicas, the largest entry of ``|W_prog -
  W_ref|`` over the largest entry of ``|W_ref - W0_ref|``, the step the
  replica's own fit takes, every ``W`` first centred over the classes
  (each row less its mean over the classes). A constant added to one
  row of every class changes no probability: the bias row's share of it
  has no curvature but the solver's jitter, so float32 rounding drifts it
  by ~1e-4 while the model stays the same (raw gap ~2.5e-3 of the step
  where the centred gap is ~2e-6, on 60,000 rows on the CPU). A replica
  whose columns are not the drawn ones (the identity here) reads at
  least 1, a step as wrong as not taking it;
- ``newton_gap``: how far each judged replica's W misses the
  reference's Newton system, in the units of the gradient: the residual
  ``(H_r + D)(W_prog - W_ref)`` of the replica's damped Hessian, less
  its mean over the judged replicas, in norm over the norm of their
  gradients less theirs. The residual weighs an error along a direction
  of small curvature by that curvature (float32's noise in the solve
  lies there) and keeps an error of the Hessian itself; the mean taken
  away is the error every replica shares through the pooled start. It
  holds the Gram's operand type: on an H100 the program reads ~1.7e-5
  on float32 operands and ~6.4e-5 on bfloat16 ones, where ``w_gap``
  reads alike for both;
- ``proba_gap``: the largest gap of a served probability from the
  reference's mean over the program's fitted replicas.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import threefry

ROW_BLOCK = 32768


def _fp32_exact():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits (to nearest,
    ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _centred(W: torch.Tensor) -> torch.Tensor:
    """``W`` less its mean over the classes (the last axis)."""
    return W - W.mean(dim=-1, keepdim=True)


def _solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(g, torch.linalg.cholesky(H))


def _column(W: torch.Tensor) -> torch.Tensor:
    """``(d, C)`` as the system's ``(C d, 1)`` class-major column."""
    return W.T.reshape(-1, 1)


class Reference:
    def __init__(self, config: dict, tables, device):
        _fp32_exact()
        self.config = config
        self.device = device
        p = config["estimator"]["learner"]["params"]
        ref = config["reference"]
        self.l2 = float(p["l2"])
        self.max_iter = int(p["max_iter"])
        self.pooled_iter = int(p["pooled_iter"])
        self.damping = float(ref["solver_damping"])
        self.bias_jitter = float(ref["bias_jitter"])
        self.n_classes = int(config["data"]["n_classes"])
        self.tables = tables
        X = torch.from_numpy(tables.X_fit).to(device, torch.float64)
        self.Xb = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
        del X
        self.y = torch.from_numpy(tables.y_fit).to(device)
        self.n, self.d = self.Xb.shape
        C = self.n_classes
        pairs = [(c, cp) for c in range(C) for cp in range(c, C)]
        self.ci = torch.tensor([a for a, _ in pairs], device=device)
        self.cpi = torch.tensor([b for _, b in pairs], device=device)
        self.pair_of = {pc: k for k, pc in enumerate(pairs)}
        self._W0 = None

    # -- the Newton solve ------------------------------------------------

    def _system(self, W, w, tf32: bool = False):
        """The damped Newton system of the weighted problem at ``W``:
        the gradient ``g`` as a ``(C d, 1)`` column (class-major) and the
        damped Hessian ``H``; in float64, or (the control) in float32
        with every product's operands rounded to TF32."""
        C, d = self.n_classes, self.d
        dt = W.dtype
        rnd = _tf32 if tf32 else (lambda t: t)
        npairs = self.ci.numel()
        G = torch.zeros((d, C), dtype=dt, device=self.device)
        grams = torch.zeros((d, npairs, d), dtype=dt, device=self.device)
        delta_cc = (self.ci == self.cpi).to(dt)
        Wr = rnd(W)
        for s in range(0, self.n, ROW_BLOCK):
            Xb = rnd(self.Xb[s:s + ROW_BLOCK].to(dt))
            wb = w[s:s + ROW_BLOCK]
            P = torch.softmax(Xb @ Wr, dim=-1)
            Y = torch.nn.functional.one_hot(self.y[s:s + ROW_BLOCK],
                                            C).to(dt)
            G += Xb.T @ rnd((P - Y) * wb[:, None])
            S = wb[:, None] * P[:, self.ci] * (delta_cc - P[:, self.cpi])
            packed = (Xb[:, None, :] * S[:, :, None]).reshape(len(wb), -1)
            grams += (Xb.T @ rnd(packed)).reshape(d, npairs, d)
            del P, Y, S, packed
        ws = torch.clamp_min(w.sum(), 1e-12)
        pen_grad = self.l2 * W
        pen_grad[-1, :] = 0.0
        G = G / ws + pen_grad
        H = torch.empty((C * d, C * d), dtype=dt, device=self.device)
        for c in range(C):
            for cp in range(C):
                k = self.pair_of[(min(c, cp), max(c, cp))]
                H[c * d:(c + 1) * d, cp * d:(cp + 1) * d] = grams[:, k, :]
        H /= ws
        pen = torch.full((d,), self.l2, dtype=dt, device=self.device)
        pen[-1] = self.bias_jitter
        H += torch.diag(pen.repeat(C) + self.damping)
        return G.T.reshape(C * d, 1), H

    def _step(self, W, w, tf32: bool = False):
        """One damped Newton step of the weighted problem from ``W``."""
        g, H = self._system(W, w, tf32)
        return W - _solve(H, g).reshape(self.n_classes, self.d).T

    def _pooled(self, dt, tf32: bool = False) -> torch.Tensor:
        W = torch.zeros((self.d, self.n_classes), dtype=dt,
                        device=self.device)
        w = torch.ones(self.n, dtype=dt, device=self.device)
        for _ in range(self.pooled_iter):
            W = self._step(W, w, tf32)
        return W

    @property
    def W0(self) -> torch.Tensor:
        """The pooled start, ``(d+1, C)`` float64."""
        if self._W0 is None:
            self._W0 = self._pooled(torch.float64)
        return self._W0

    def replica(self, seed: int, r: int, W0=None,
                tf32: bool = False) -> torch.Tensor:
        """Replica ``r`` of a fit with seed ``seed``: ``(d+1, C)``."""
        return self._replica(seed, r, W0, tf32)[0]

    def _replica(self, seed, r, W0=None, tf32=False):
        """Replica ``r`` and the (gradient, damped Hessian) of its last
        Newton step."""
        W = self.W0 if W0 is None else W0
        w = threefry.row_counts(seed, r, self.n, self.device).to(W.dtype)
        for _ in range(self.max_iter):
            g, H = self._system(W, w, tf32)
            W = W - _solve(H, g).reshape(self.n_classes, self.d).T
        return W, g, H

    # -- the numbers -----------------------------------------------------

    def fit_numbers(self, records, sample) -> dict:
        """``records``: the fits (``seed``, ``params``, ``subspaces``);
        ``sample``: ``(fit index, replica)`` pairs to compare."""
        if len(sample) < 2:
            raise ValueError("newton_gap needs two judged replicas or more")
        w_gap = 0.0
        F = self.d - 1
        res, grads = [], []
        for j, r in sample:
            rec = records[j]
            W_ref, g, H = self._replica(rec["seed"], r)
            W_ref = _centred(W_ref)
            W_prog = _centred(rec["params"]["W"][r].to(self.device,
                                                        torch.float64))
            step = float((W_ref - _centred(self.W0)).abs().max())
            w_gap = max(w_gap, float((W_prog - W_ref).abs().max())
                        / max(step, 1e-30))
            res.append(H @ _column(W_prog - W_ref))
            grads.append(g)
            want = threefry.subspace(rec["seed"], r, F, F, self.device)
            got = rec["subspaces"][r].to(self.device, torch.int64)
            if got.shape != want.shape or bool((got != want).any()):
                w_gap = max(w_gap, 1.0)
        res, grads = torch.stack(res), torch.stack(grads)
        newton_gap = float(torch.linalg.norm(res - res.mean(0))
                           / torch.linalg.norm(grads - grads.mean(0)))
        return {"w_gap": w_gap, "newton_gap": newton_gap}

    def forward(self, W: torch.Tensor, X_np: np.ndarray,
                tf32: bool = False) -> np.ndarray:
        """The mean over replicas of their softmax probabilities on
        ``X``: in float64, or (the control) in float32 with the product's
        operands rounded to TF32 as the tensor cores round them, the
        same on any device."""
        dt = torch.float32 if tf32 else torch.float64
        X = torch.from_numpy(X_np).to(self.device, dt)
        Xb = torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
        del X
        Wd = W.to(self.device, dt)
        if tf32:
            Xb, Wd = _tf32(Xb), _tf32(Wd)
        acc = torch.zeros((Xb.shape[0], Wd.shape[-1]), dtype=torch.float64,
                          device=self.device)
        for s in range(0, Wd.shape[0], 25):
            blk = Wd[s:s + 25]                              # (b, d+1, C)
            b, d1, C = blk.shape
            scores = (Xb @ blk.permute(1, 0, 2).reshape(d1, b * C))
            acc += torch.softmax(scores.reshape(-1, b, C),
                                 dim=-1).sum(1).double()
        return (acc / Wd.shape[0]).cpu().numpy()

    def predict_numbers(self, record, outputs: list[np.ndarray]) -> dict:
        want = self.forward(record["params"]["W"], self.tables.X_pred)
        gap = max(float(np.abs(o.astype(np.float64) - want).max())
                  for o in outputs)
        return {"proba_gap": gap}

    # -- the controls ----------------------------------------------------

    def control_fit(self, seed: int, replicas: list[int]) -> dict:
        """The reference fit in the program's place, in float32 with
        every product's operands rounded to TF32: ``{replica: (state,
        columns)}``."""
        W0 = self._pooled(torch.float32, tf32=True)
        cols = torch.arange(self.d - 1, dtype=torch.int32,
                            device=self.device)
        return {r: ({"W": self.replica(seed, r, W0, tf32=True)}, cols)
                for r in replicas}

    def control_predict(self, record) -> np.ndarray:
        """The reference in the program's place, its product's operands
        rounded to TF32."""
        return self.forward(record["params"]["W"], self.tables.X_pred,
                            tf32=True).astype(np.float32)
