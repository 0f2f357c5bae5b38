"""The plain reference of a bag of binary Newton-boosted trees, in torch
(float64 sums, float32 features as given).

What a fit of ``BaggingClassifier(GBTClassifier(n_rounds=M, max_depth=d,
lr=a, n_bins=B, hist_dtype="bfloat16"))`` computes, written from the
definition of logistic Newton boosting and worked out again from the
inputs alone:

- bin edges: ``tree_gini.binning``'s (per feature, the fit rows' order
  statistics, then ``+inf``); a candidate split of a node is a ``(column,
  edge)``, rows with ``x > edge`` going right;
- replica ``r``: its Poisson counts ``w`` (``reference/threefry.py``)
  over every column (``max_features`` 1: the identity subspace);
- ``f0 = logit(clamp(sum w y / sum w, 1e-6, 1 - 1e-6))``, the margin
  ``F = f0`` on every row;
- each round: ``p = sigmoid(F)``, ``u = max(p (1 - p), 1e-6)``, ``h = w
  u``, ``z = (y - p) / u``; the moments ``(h, h z, h z^2)`` rounded to
  bfloat16 where ``hist_dtype`` says so (a configuration run on the CPU
  states ``"float32"``: the port's CPU path sums them unrounded), summed
  exactly (float64); level by
  level, every node's best candidate is the one of least summed squared
  error ``S2 - S1^2 / S0`` over its two sides (the Newton gain
  ``G_L^2/H_L + G_R^2/H_R`` at its largest); the leaves are the Newton
  steps ``G / H`` of the unrounded moments (``G = sum h z``, ``H = sum
  h``; 0 where ``H = 0``); ``F += a leaf[node]``.

A split chosen between candidates whose sums differ only by rounding is
as good as the other, and the rows below it then differ. So the check
follows the program's own trees: round by round the reference routes the
rows by the program's splits, recomputes every node's sums from its own
margin and judges the program's choice against its own best; its leaves
and margin are its own, under the program's routing. The binning, the
draws and ``f0`` depend on nothing of the program's.

Numbers compared (lower is better):

- ``split_gap``: over every node of every round of the sampled replicas,
  the program's split's squared error above the node's best, over the
  node's ``S2 = sum h z^2`` (the size of the score itself, so float32
  rounding of the program's sums reads ~1e-7); a threshold that is not
  one of the reference's edges of its column, or a replica whose columns
  are not the drawn ones, reads 1;
- ``leaf_gap``: the largest gap of a program leaf from the reference's,
  over the largest reference leaf of that round;
- ``margin_gap``: the largest gap, over the fit rows, between the margin
  of the program's trees (``f0 + a sum_m leaf_m[node_m]`` of its state,
  in float64) and the reference's final margin, in log-odds: a round
  skipped, another ``lr`` or another ``f0`` shows here.
"""

from __future__ import annotations

import torch

from reference import threefry
from reference.tree_gini import binning

_HESS_FLOOR = 1e-6
_PRIOR_CLAMP = 1e-6
_EPS = 1e-12


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest even), back in float64."""
    return t.to(torch.float32).to(torch.bfloat16).to(torch.float64)


def _sse(s: torch.Tensor) -> torch.Tensor:
    """Squared error ``S2 - S1^2 / S0`` of moment sums ``(..., 3)``."""
    return s[..., 2] - s[..., 1] ** 2 / torch.clamp_min(s[..., 0], _EPS)


class Reference:
    def __init__(self, config: dict, tables, device):
        p = config["estimator"]["learner"]["params"]
        bag = config["estimator"]["params"]
        self.depth = int(p["max_depth"])
        self.rounds = int(p["n_rounds"])
        self.lr = float(p["lr"])
        self.B = int(p["n_bins"])
        self.round_moments = p.get("hist_dtype", "bfloat16") == "bfloat16"
        self.device = device
        self.X = torch.from_numpy(tables.X_fit).to(device)
        self.y = torch.from_numpy(tables.y_fit).to(device, torch.float64)
        self.n, self.F = self.X.shape
        self.k = max(1, min(self.F, round(float(bag.get("max_features", 1.0))
                                          * self.F)))
        self.edges, _ = binning(self.X, self.B)
        # every candidate's left side, [x <= edge], as (F B, n) float64:
        # a level's left sums are one product with the node-scattered
        # moments
        self.T = (self.X.T[:, None, :] <= self.edges[:, :, None]).reshape(
            self.F * self.B, self.n).to(torch.float64)

    # -- one replica's boosting ------------------------------------------

    def boost(self, w: torch.Tensor, follow: dict | None = None,
              lowp: bool = False) -> dict:
        """The boosting of one replica with counts ``w``. With ``follow``
        (the program's ``feature`` and ``threshold``, ``(rounds M,)``) the
        rows are routed by its splits and each is judged; without, the
        reference picks its own. ``lowp``: the leaf sums and the margin
        held in bfloat16 (the control). Returns ``f0``, ``feature``,
        ``threshold``, ``leaf`` ``(rounds, L)``, the final margin ``F``,
        each round's leaf index of every row (``nodes``) and the largest
        judged split gap."""
        n, dev, B, d = self.n, self.device, self.B, self.depth
        M, L = 2 ** d - 1, 2 ** d
        wd = w.to(dev, torch.float64)
        y = self.y
        prior = (wd * y).sum() / torch.clamp_min(wd.sum(), _EPS)
        prior = torch.clamp(prior, _PRIOR_CLAMP, 1.0 - _PRIOR_CLAMP)
        f0 = torch.log(prior / (1.0 - prior))
        if lowp:
            f0 = _bf16(f0)
        F = f0.expand(n).clone()
        rows = torch.arange(n, device=dev)
        feats, thrs, leaves, nodes = [], [], [], []
        gap = 0.0
        for m in range(self.rounds):
            p = torch.sigmoid(F)
            u = torch.clamp_min(p * (1.0 - p), _HESS_FLOOR)
            h = wd * u
            z = (y - p) / u
            S = torch.stack([h, h * z, h * z * z], dim=-1)       # (n, 3)
            Sb = _bf16(S) if self.round_moments else S  # the operands
            node = torch.zeros(n, dtype=torch.int64, device=dev)
            for level in range(d):
                N = 2 ** level
                hot = node[:, None] == torch.arange(N, device=dev)
                stats = (hot[:, :, None] * Sb[:, None, :]).reshape(n, N * 3)
                left = (self.T @ stats).reshape(self.F, B, N, 3)
                right = left[:, -1:] - left
                score = _sse(left) + _sse(right)                  # (F, B, N)
                flat = score.permute(2, 0, 1).reshape(N, self.F * B)
                best_val, best = flat.min(dim=1)
                if follow is None:
                    f = best // B
                    t = self.edges[f, best % B]
                else:
                    off = m * M + N - 1
                    f = follow["feature"][off:off + N].to(dev, torch.int64)
                    t = follow["threshold"][off:off + N].to(dev,
                                                            torch.float32)
                    on = (f >= 0) & (f < self.F)
                    f = torch.where(on, f, 0)
                    match = self.edges[f] == t[:, None]           # (N, B)
                    b = match.to(torch.float32).argmax(dim=1)
                    s_p = flat.gather(1, (f * B + b)[:, None])[:, 0]
                    s2 = torch.clamp_min(left[0, -1, :, 2], 1e-30)
                    regret = (s_p - best_val) / s2
                    regret = torch.where(match.any(dim=1) & on, regret, 1.0)
                    gap = max(gap, float(regret.max()))
                feats.append(f)
                thrs.append(t)
                x = self.X[rows, f[node]]
                node = node * 2 + (x > t[node]).to(torch.int64)
            G = torch.bincount(node, weights=S[:, 1], minlength=L)
            H = torch.bincount(node, weights=S[:, 0], minlength=L)
            if lowp:
                G, H = _bf16(G), _bf16(H)
            leaf = torch.where(H > 0, G / torch.clamp_min(H, _EPS), 0.0)
            F = F + self.lr * leaf[node]
            if lowp:
                F = _bf16(F)
            leaves.append(leaf)
            nodes.append(node)
        return {"f0": f0, "feature": torch.cat(feats).to(torch.int32),
                "threshold": torch.cat(thrs), "leaf": torch.stack(leaves),
                "F": F, "nodes": nodes, "split_gap": gap}

    # -- the numbers -----------------------------------------------------

    def fit_numbers(self, records, sample) -> dict:
        split_gap = leaf_gap = margin_gap = 0.0
        for j, r in sample:
            rec = records[j]
            cols = threefry.subspace(rec["seed"], r, self.F, self.k,
                                     self.device)
            got = rec["subspaces"][r].to(self.device, torch.int64)
            if got.shape != cols.shape or bool((got != cols).any()):
                split_gap = 1.0
            w = threefry.row_counts(rec["seed"], r, self.n, self.device)
            prm = rec["params"]
            ref = self.boost(w, follow={"feature": prm["feature"][r],
                                        "threshold": prm["threshold"][r]})
            split_gap = max(split_gap, ref["split_gap"])
            leaf = prm["leaf"][r].to(self.device, torch.float64)
            scale = torch.clamp_min(ref["leaf"].abs().amax(dim=1), _EPS)
            leaf_gap = max(leaf_gap, float(
                ((leaf - ref["leaf"]).abs().amax(dim=1) / scale).max()))
            margin = prm["f0"][r].to(self.device, torch.float64).expand(
                self.n).clone()
            for m, node in enumerate(ref["nodes"]):
                margin += self.lr * leaf[m][node]
            margin_gap = max(margin_gap,
                             float((margin - ref["F"]).abs().max()))
        return {"split_gap": split_gap, "leaf_gap": leaf_gap,
                "margin_gap": margin_gap}

    # -- the control -----------------------------------------------------

    def control_fit(self, seed: int, replicas: list[int]) -> dict:
        """The reference in the program's place with its leaf sums and
        margin held in bfloat16: ``{replica: (state, columns)}``."""
        out = {}
        for r in replicas:
            cols = threefry.subspace(seed, r, self.F, self.k, self.device)
            w = threefry.row_counts(seed, r, self.n, self.device)
            ctl = self.boost(w, lowp=True)
            out[r] = ({"f0": ctl["f0"].to(torch.float32),
                       "feature": ctl["feature"],
                       "threshold": ctl["threshold"].to(torch.float32),
                       "leaf": ctl["leaf"].to(torch.float32)},
                      cols.to(torch.int32))
        return out

