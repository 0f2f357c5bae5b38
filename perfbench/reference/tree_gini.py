"""The plain reference of a bag of depth-``d`` binned Gini trees on
feature subspaces, in torch (float64 sums, float32 features as given).

What a fit of ``BaggingClassifier(DecisionTreeClassifier(max_depth=d,
n_bins=B), max_features=f, voting="hard")`` computes, written from its
definition and worked out again from the inputs alone:

- bin edges: per feature, the order statistics of the fit rows at
  positions ``floor((b+1) * (n / B))`` (float32 arithmetic), ``b < B -
  1``, then ``+inf``; a row's code is the first edge it does not exceed;
- replica ``r``: its Poisson counts and its ``round(f * F)`` columns
  (``reference/threefry.py``); level by level, for every node, the
  candidate ``(column, edge)`` whose left and right sides have the least
  summed Gini mass ``W - sum_c c^2 / W`` over the count-weighted class
  histogram (the first in (column, edge) order among equals), rows with
  ``x > edge`` going right;
- leaves: ``log((count_c + a) / (total + a C))`` (``a`` the leaf
  smoothing), the uniform distribution where a leaf is empty;
- the served vote: each tree's most probable leaf class (the first
  among equals), counted over the trees and divided by their number.

A split chosen between candidates whose sums differ only by rounding is
as good as the other, and the trees below it then hold other rows. So
the comparison follows the program's own tree: at each level the
reference routes the rows by the program's splits above, recomputes
every node's histogram from its own codes and counts, and judges the
program's choice there against its own best. The root level, the
binning and the draws depend on nothing of the program's.

Numbers compared (lower is better):

- ``split_gap``: over every node of the sampled trees, the excess of the
  Gini mass of the program's split over the node's best, over the
  node's count; a split whose threshold is not one of the reference's
  edges of its column, or a tree whose columns are not the drawn ones,
  reads 1, the most a split can be off. Sums that differ only by
  float32 rounding read ~1e-7 at most;
- ``leaf_logp_gap``: the largest gap of a leaf log-probability from the
  reference's, under the program's routing;
- ``vote_gap``: the largest gap of a served vote share from the
  reference's vote over the program's trees (exact: 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import threefry

def binning(X: torch.Tensor, n_bins: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Edges ``(F, B)`` (last ``+inf``) and codes ``(F, n)`` int64."""
    n, F = X.shape
    Xs = torch.sort(X.T.contiguous(), dim=1).values
    step = np.float32(np.float32(n) / np.float32(n_bins))
    pos = (np.arange(1, n_bins, dtype=np.float32) * step).astype(np.int64)
    pos = torch.from_numpy(np.clip(pos, 0, n - 1)).to(X.device)
    edges = torch.cat([Xs[:, pos], torch.full((F, 1), math.inf,
                                              device=X.device)], dim=1)
    del Xs
    codes = torch.searchsorted(edges.contiguous(), X.T.contiguous())
    return edges.contiguous(), codes


class Reference:
    def __init__(self, config: dict, tables, device):
        p = config["estimator"]["learner"]["params"]
        bag = config["estimator"]["params"]
        self.depth = int(p["max_depth"])
        self.B = int(p["n_bins"])
        self.smoothing = float(p["leaf_smoothing"])
        self.C = int(config["data"]["n_classes"])
        self.tables = tables
        self.device = device
        self.X = torch.from_numpy(tables.X_fit).to(device)
        self.y = torch.from_numpy(tables.y_fit).to(device)
        self.n, self.F = self.X.shape
        self.k = max(1, min(self.F, round(float(bag["max_features"]) * self.F)))
        self.edges, self.codes = binning(self.X, self.B)

    def _gini(self, s: torch.Tensor) -> torch.Tensor:
        w = s.sum(-1)
        return w - (s * s).sum(-1) / torch.clamp_min(w, 1e-12)

    def grow(self, w, cols, follow=None, X=None, edges=None, codes=None):
        """One tree on counts ``w`` over columns ``cols``. With ``follow``
        (the program's ``feature`` and ``threshold``) rows are routed by
        its splits and each is judged; without, the reference picks its
        own. Returns ``(feature, threshold, leaf_logp, judged)``."""
        X = self.X if X is None else X
        E = (self.edges if edges is None else edges)[cols]        # (k, B)
        codes = (self.codes if codes is None else codes)[cols]    # (k, n)
        k, B, C, n = cols.numel(), self.B, self.C, self.n
        dev = self.device
        wd = w.double()
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        base = (torch.arange(k, device=dev)[:, None] * B + codes)
        feats, thrs = [], []
        gap = 0.0
        rows = torch.arange(n, device=dev)
        for level in range(self.depth):
            N = 2 ** level
            idx = ((base * N + node) * C + self.y).reshape(-1)
            hist = torch.bincount(idx, weights=wd.repeat(k),
                                  minlength=k * B * N * C)
            left = hist.reshape(k, B, N, C).cumsum(1)
            right = left[:, -1:] - left
            score = (self._gini(left) + self._gini(right))        # (k,B,N)
            flat = score.permute(2, 0, 1).reshape(N, k * B)
            best_val, best = flat.min(dim=1)
            if follow is None:
                f = best // B
                t = E[f, best % B]
            else:
                off = N - 1
                f = follow[0][off:off + N].to(dev, torch.int64)
                t = follow[1][off:off + N].to(dev, torch.float32)
                match = E[f] == t[:, None]                        # (N, B)
                b = match.to(torch.float32).argmax(dim=1)
                s_p = flat.gather(1, (f * B + b)[:, None])[:, 0]
                parent = left[0, -1].sum(-1)                      # (N,)
                regret = (s_p - best_val) / torch.clamp_min(parent, 1.0)
                regret = torch.where(match.any(dim=1), regret, 1.0)
                gap = max(gap, float(regret.max()))
            feats.append(f)
            thrs.append(t)
            x = X[rows, cols[f[node]]]
            node = node * 2 + (x > t[node]).to(torch.int64)
        L = 2 ** self.depth
        counts = torch.bincount(node * C + self.y, weights=wd,
                                minlength=L * C).reshape(L, C)
        tot = counts.sum(-1, keepdim=True)
        a = self.smoothing
        logp = torch.where(tot > 0, torch.log((counts + a) / (tot + a * C)),
                           torch.full_like(counts, math.log(1.0 / C)))
        return torch.cat(feats).to(torch.int32), torch.cat(thrs), logp, gap

    # -- the numbers -----------------------------------------------------

    def fit_numbers(self, records, sample) -> dict:
        split_gap = leaf_gap = 0.0
        for j, r in sample:
            rec = records[j]
            cols = threefry.subspace(rec["seed"], r, self.F, self.k,
                                     self.device)
            got = rec["subspaces"][r].to(self.device, torch.int64)
            if got.shape != cols.shape or bool((got != cols).any()):
                split_gap = 1.0
            w = threefry.row_counts(rec["seed"], r, self.n, self.device)
            prm = rec["params"]
            _, _, logp, gap = self.grow(
                w, cols, follow=(prm["feature"][r], prm["threshold"][r]))
            split_gap = max(split_gap, gap)
            got_logp = prm["leaf_logp"][r].to(self.device, torch.float64)
            leaf_gap = max(leaf_gap, float((got_logp - logp).abs().max()))
        return {"split_gap": split_gap, "leaf_logp_gap": leaf_gap}

    def vote(self, params, subspaces, X_np: np.ndarray,
             bf16: bool = False) -> np.ndarray:
        """The hard vote of the trees ``params`` on ``X``."""
        X = torch.from_numpy(X_np).to(self.device)
        if bf16:
            X = X.bfloat16().float()
        feature = params["feature"].to(self.device, torch.int64)
        threshold = params["threshold"].to(self.device)
        logp = params["leaf_logp"].to(self.device)
        cols = subspaces.to(self.device, torch.int64)
        R, m = feature.shape[0], X.shape[0]
        counts = torch.zeros((m, self.C), dtype=torch.float64,
                             device=self.device)
        rows = torch.arange(m, device=self.device)
        for r in range(R):
            rel = torch.zeros(m, dtype=torch.int64, device=self.device)
            for level in range(self.depth):
                off = 2 ** level - 1
                f = feature[r, off + rel]
                x = X[rows, cols[r, f]]
                rel = rel * 2 + (x > threshold[r, off + rel]).to(torch.int64)
            cls = logp[r].argmax(dim=-1)[rel]
            counts[rows, cls] += 1.0
        # integer counts over the tree count, divided in float32 as served
        return (counts.float() / R).cpu().numpy()

    def predict_numbers(self, record, outputs: list[np.ndarray]) -> dict:
        want = self.vote(record["params"], record["subspaces"],
                         self.tables.X_pred)
        gap = max(float(np.abs(o.astype(np.float64) - want).max())
                  for o in outputs)
        return {"vote_gap": gap}

    # -- the controls ----------------------------------------------------

    def control_fit(self, seed: int, replicas: list[int]) -> dict:
        """The reference in the program's place with its features
        rounded to bfloat16: ``{replica: (state, columns)}``."""
        X16 = self.X.bfloat16().float()
        edges, codes = binning(X16, self.B)
        out = {}
        for r in replicas:
            cols = threefry.subspace(seed, r, self.F, self.k, self.device)
            w = threefry.row_counts(seed, r, self.n, self.device)
            f, t, logp, _ = self.grow(w, cols, X=X16, edges=edges,
                                      codes=codes)
            out[r] = ({"feature": f, "threshold": t,
                       "leaf_logp": logp.float()}, cols.to(torch.int32))
        return out

    def control_predict(self, record) -> np.ndarray:
        """The reference vote in the program's place, on bfloat16
        features."""
        return self.vote(record["params"], record["subspaces"],
                         self.tables.X_pred, bf16=True).astype(np.float32)
