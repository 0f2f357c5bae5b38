"""Gradient-boosted trees (Spark ML's ``GBTClassifier``/``GBTRegressor``),
batched over a leading replica axis.

The port of the JAX package's ``models/gbt.py``: Newton boosting over
the tree engine of models/tree.py. Every round grows one depth-bounded
tree per replica of the chunk on the current pseudo-residuals, as one
``_grow`` call over the chunk's trees; the JAX package's ``lax.scan``
over rounds is a Python loop here.

The reduction to the tree engine is exact: Newton boosting fits each
tree to targets ``z = -g/h`` under row weights ``h`` (the per-row loss
Hessian). The regression tree's weighted-SSE split score on the moments
``(h, h z, h z^2)`` is then the XGBoost gain ``G_L^2/H_L + G_R^2/H_R``
(the ``sum g^2/h`` term does not depend on the split), and the
weighted-mean leaf value is the Newton step ``-G/H``. The moments are
floats, so on the card every level runs the histogram kernel's float
accumulator. Quantile bin edges are computed once a fit (``prepare``)
and shared by every round and replica; a feature subspace is read
through each replica's column index, as the trees read it.

On a data mesh (``axis_name``) the initial margin, every level's table,
the leaf sums and the round losses sum over the row shards, the edges
are the shards' averaged quantiles, and each shard draws its own rows'
keep mask (stochastic GBT): every shard grows the same trees. The
tables are summed as floats after each shard's fixed-point pass (each
shard scales by its own ``max |S|``), so a mesh fit is not bitwise the
single-device fit, as in the JAX package.

Each round runs inside a ``boost_round`` span (attr ``round``), which
holds the round's ``tree_level`` spans and its ``leaf_stats``; a learner
fit counts its rounds and trees once, in ``sbt_gbt_rounds_total`` and
``sbt_gbt_trees_total``.

Params keep the JAX layout with the replica axis leading: ``f0`` ``(R,)``
(``(R, C)`` multiclass), ``feature``/``threshold``/``gain`` ``(R,
rounds·M)`` (``(R, rounds·C·M)``, in (round, class, node) order) and
``leaf`` ``(R, rounds, L)`` (``(R, rounds, C, L)``), so the bagging
surface (``feature_importances_``, ``replica_params``,
``from_jax_arrays``) takes them as it takes a tree's.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.models.tree import DecisionTreeRegressor, _EPS
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

# a saturated sigmoid makes h -> 0; the floor keeps z = -g/h finite
_HESS_FLOOR = 1e-6
# fold tags of the round key: the row mask and the class trees' keys
_ROW_MASK_TAG = 0x5B
_CLASS_TAG = 0x7EEE


class _GBTBase(DecisionTreeRegressor):
    """The shared boosting engine (see the module docstring).

    Parameters mirror Spark's: ``n_rounds`` (maxIter), ``lr``
    (stepSize), ``max_depth``, ``subsample`` (subsamplingRate: each
    round trains on an independent Bernoulli row subset drawn from the
    round key), and the tree engine's ``n_bins`` / ``hist_dtype`` /
    ``split_impl`` / ``feature_subset``.
    """

    # a fit is rounds of trees over margins of the whole dataset, not the
    # one tree the streamed tree engine grows (tree_stream.py)
    tree_streamable = False

    def __init__(
        self,
        n_rounds: int = 20,
        max_depth: int = 5,
        lr: float = 0.1,
        subsample: float = 1.0,
        n_bins: int = 32,
        hist_dtype: str = "bfloat16",
        precision: str = "highest",
        split_impl: str = "auto",
        feature_subset: str | float | int | None = None,
    ):
        super().__init__(
            max_depth, n_bins, hist_dtype, precision, split_impl,
            feature_subset,
            # the pre-pruning gates stay off: GBT split statistics carry
            # Newton Hessian mass, not row counts
            min_info_gain=0.0,
            min_instances_per_node=0.0,
        )
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        if not 0.0 < lr <= 1.0:
            raise ValueError(f"lr must be in (0, 1], got {lr}")
        if not 0.0 < subsample <= 1.0:
            raise ValueError(
                f"subsample must be in (0, 1], got {subsample}"
            )
        self.n_rounds = n_rounds
        self.lr = lr
        self.subsample = subsample

    # -- shared round machinery ----------------------------------------

    def _validate_fit_key(self, keys) -> None:
        if self.subsample < 1.0 and keys is None:
            raise ValueError(
                "subsample < 1 draws per-round row subsets from the "
                "replica fit key; fit was called with key=None"
            )

    @staticmethod
    def _newton_leaf(stats):
        """Leaf Newton step ``-G/H``, the weighted mean of z under h, from
        leaf sums ``(..., L, 3)``; an empty leaf gives 0 (no update)."""
        return torch.where(
            stats[..., 0] > 0,
            stats[..., 1] / torch.clamp_min(stats[..., 0], _EPS),
            0.0,
        )

    def _round_row_mask(self, key_m, n, axis_name=None):
        """Stochastic-GBT keep mask ``(R, n)`` of one round, None when
        subsample == 1: ``uniform(fold_in(key_m, 0x5B), (n,)) <
        subsample`` per replica, the JAX package's draw. On a data mesh
        the shard's index is folded in after the tag, so each shard
        draws its own rows' mask."""
        if self.subsample >= 1.0:
            return None
        mask_key = prng.fold_in(key_m, _ROW_MASK_TAG)
        if axis_name is not None:
            from spark_bagging_tpu_torch.parallel.compat import axis_index

            mask_key = prng.fold_in(mask_key, axis_index(axis_name))
        return (prng.uniform(mask_key, n) < self.subsample).to(torch.float32)

    def _count_rounds(self, trees_per_round: int) -> None:
        """One learner fit's rounds, and the trees they grew
        (``trees_per_round`` a round: a tree a replica, or a replica's
        class)."""
        telemetry.inc_many((
            ("sbt_gbt_rounds_total", float(self.n_rounds)),
            ("sbt_gbt_trees_total", float(self.n_rounds * trees_per_round)),
        ))

    # -- per-task hooks -------------------------------------------------

    def _init_margin(self, y, w, w_sum, axis_name=None):
        raise NotImplementedError

    def _pseudo(self, y, F, w):
        """(h, z): Newton row weights and targets at margin F."""
        raise NotImplementedError

    def _round_loss(self, y, F, w, w_sum, axis_name=None):
        raise NotImplementedError

    # -- BaseLearner contract ------------------------------------------

    def init_params(self, keys, n_features, n_outputs):
        R, dev = keys.shape[0], keys.device
        M, L = 2**self.max_depth - 1, 2**self.max_depth
        rounds = self.n_rounds
        return {
            "f0": torch.zeros((R,), dtype=torch.float32, device=dev),
            # flat (rounds·M) a replica, so feature_importances_ reads
            # gains and features as it does a single tree's
            "feature": torch.zeros((R, rounds * M), dtype=torch.int32,
                                   device=dev),
            "threshold": torch.zeros((R, rounds * M), dtype=torch.float32,
                                     device=dev),
            "gain": torch.zeros((R, rounds * M), dtype=torch.float32,
                                device=dev),
            "leaf": torch.zeros((R, rounds, L), dtype=torch.float32,
                                device=dev),
        }

    def _trees_per_round(self, n_outputs: int) -> int:
        return 1

    def _stats_per_row(self, n_outputs: int) -> int:
        return 3  # (h, h z, h z^2), whatever the task

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        del n_outputs
        # every round contracts K = 3 moments (h, h z, h z^2), whatever
        # the task
        nodes_total = 2**self.max_depth - 1
        one_tree = 2 * n_rows * n_features * self.n_bins * 3 * nodes_total
        return float(self.n_rounds * one_tree)

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        # a round's eager temporaries a replica: the regression tree's
        # (K = 3 moments) for each tree the round grows, plus the (n,)
        # margin (n, C for multiclass) and the vectors made from it each
        # round: probabilities, Hessians, targets, the labels and the
        # loss terms, eight of the margin's size in all
        trees = self._trees_per_round(n_outputs)
        tree = super().fit_workset_bytes(n_rows, n_features, n_outputs,
                                         device)
        return float(tree * trees + 8 * 4.0 * n_rows * trees)

    def to_debug_string(self, params, feature_names=None) -> str:
        """Per-round tree dumps of ONE replica (Spark's
        ``GBT*Model.toDebugString``), from its params as numpy
        (``replica_params(i)[0]``): each round's (and class's) node
        arrays rendered by the single-tree walker."""
        M = 2**self.max_depth - 1
        leaf = np.asarray(params["leaf"])
        feature = np.asarray(params["feature"])
        threshold = np.asarray(params["threshold"])
        multiclass = leaf.ndim == 3
        R = leaf.shape[0]
        C = leaf.shape[1] if multiclass else 1
        f0 = np.asarray(params["f0"])
        out = [
            f"{type(self).__name__} (rounds={R}, depth={self.max_depth},"
            f" lr={self.lr}, f0={np.round(f0, 4).tolist()})"
        ]
        for r in range(R):
            for c in range(C):
                i = (r * C + c) * M
                sub = {
                    "feature": feature[i:i + M],
                    "threshold": threshold[i:i + M],
                    "leaf_value": leaf[r, c] if multiclass else leaf[r],
                }
                title = (
                    f"Tree {r} (class {c}):" if multiclass
                    else f"Tree {r}:"
                )
                body = super().to_debug_string(sub, feature_names)
                out.append(title)
                out.append("\n".join(body.split("\n")[1:]))  # no header
        return "\n".join(out)

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del params
        self._validate_fit_key(keys)
        if prepared is None:
            prepared = self.prepare(X, axis_name=axis_name)
        yf = y.to(torch.float32)
        w = sample_weight.to(torch.float32)                  # (R, n)
        # the _EPS guard: an all-zero bootstrap draw must not make f0 NaN
        w_sum = torch.clamp_min(maybe_psum(w.sum(-1), axis_name), _EPS)
        f0 = self._init_margin(yf, w, w_sum, axis_name)      # (R,)
        R, n = w.shape
        F = f0[:, None].expand(R, n)
        feats, thrs, gains, leaves, losses = [], [], [], [], []
        for m in range(self.n_rounds):
            with telemetry.span("boost_round", round=m):
                h, z = self._pseudo(yf, F, w)
                key_m = prng.fold_in(keys, m) if keys is not None else None
                keep = self._round_row_mask(key_m, n, axis_name)
                if keep is not None:
                    # stochastic GBT: dropped rows carry zero weight
                    # through every split statistic and leaf sum of this
                    # round
                    h = h * keep
                S = torch.stack([h, h * z, h * z * z], dim=-1)
                feat, thr, gain, node, _ = self._grow(
                    X, S, prepared, key_m, axis_name=axis_name)
                leaf = self._newton_leaf(
                    self._leaf_stats(node, S, axis_name))      # (R, L)
                F = F + self.lr * leaf.gather(1, node.long())
                feats.append(feat)
                thrs.append(thr)
                gains.append(gain)
                leaves.append(leaf)
                losses.append(self._round_loss(yf, F, w, w_sum, axis_name))
        self._count_rounds(R)
        curve = torch.stack(losses, dim=1)
        new = {
            "f0": f0,
            "feature": torch.cat(feats, dim=1),
            "threshold": torch.cat(thrs, dim=1),
            "gain": torch.cat(gains, dim=1).to(torch.float32),
            "leaf": torch.stack(leaves, dim=1).to(torch.float32),
        }
        return new, {"loss": curve[:, -1], "loss_curve": curve}

    def _margin(self, params, X, cols=None):
        """``f0 + sum_m lr leaf_m[route_m(x)]`` ``(R, n)``, round by
        round in the fit's order."""
        M = 2**self.max_depth - 1
        f0, leaves = params["f0"], params["leaf"]
        acc = f0[:, None].expand(f0.shape[0], X.shape[-2])
        for m in range(leaves.shape[1]):
            rnd = {k: params[k][:, m * M:(m + 1) * M]
                   for k in ("feature", "threshold")}
            rel = self._route(rnd, X, cols)
            acc = acc + self.lr * leaves[:, m].gather(1, rel)
        return acc


class GBTRegressor(_GBTBase):
    """Least-squares Newton boosting (h = w, z = the residual)."""

    task = "regression"

    def _init_margin(self, y, w, w_sum, axis_name=None):
        return maybe_psum((w * y).sum(-1), axis_name) / w_sum

    def _pseudo(self, y, F, w):
        return w, y - F

    def _round_loss(self, y, F, w, w_sum, axis_name=None):
        return maybe_psum((w * (y - F) ** 2).sum(-1), axis_name) / w_sum

    def predict_scores(self, params, X, cols=None):
        return self._margin(params, X, cols)


class GBTClassifier(_GBTBase):
    """Logistic / multinomial Newton boosting.

    Binary problems grow one margin tree a round (Spark's GBTClassifier);
    ``predict_scores`` returns ``(R, n, 2)`` logits ``[0, margin]``, so
    the softmax is the sigmoid. Multiclass problems grow C trees a round
    (diagonal-Newton multinomial boosting): the R·C trees of a chunk's
    round grow in one ``_grow`` call, so one histogram launch a level
    covers every (replica, class).
    """

    task = "classification"

    def init_params(self, keys, n_features, n_outputs):
        if n_outputs < 2:
            raise ValueError(
                f"GBTClassifier needs >= 2 classes, got {n_outputs} "
                "(a 1-class softmax would silently train a constant)"
            )
        if n_outputs == 2:
            return super().init_params(keys, n_features, n_outputs)
        R, dev = keys.shape[0], keys.device
        M, L = 2**self.max_depth - 1, 2**self.max_depth
        rounds, C = self.n_rounds, n_outputs
        return {
            "f0": torch.zeros((R, C), dtype=torch.float32, device=dev),
            "feature": torch.zeros((R, rounds * C * M), dtype=torch.int32,
                                   device=dev),
            "threshold": torch.zeros((R, rounds * C * M),
                                     dtype=torch.float32, device=dev),
            "gain": torch.zeros((R, rounds * C * M), dtype=torch.float32,
                                device=dev),
            "leaf": torch.zeros((R, rounds, C, L), dtype=torch.float32,
                                device=dev),
        }

    def _trees_per_round(self, n_outputs: int) -> int:
        return n_outputs if n_outputs > 2 else 1

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        one = super().flops_per_fit(n_rows, n_features, n_outputs)
        return one * (1 if n_outputs == 2 else n_outputs)

    # -- multiclass engine (C trees a round, grown together) -----------

    @staticmethod
    def _class_prepared(prepared, C):
        """The prepared state of R replicas for their R·C class trees
        (tree r·C + c is replica r's class-c tree): per-replica edges,
        columns and dense indicator slices repeated C times; the shared
        edges and codes stay shared."""
        per_replica = {"edges": 3, "cols": 2, "T": 4}  # dims with R
        return {k: (v.repeat_interleave(C, dim=0)
                    if v.dim() == per_replica.get(k) else v)
                for k, v in prepared.items()}

    def _fit_multiclass(self, params, X, y, w, keys, prepared,
                        axis_name=None):
        C = params["leaf"].shape[2]
        R, n = w.shape
        yf32 = torch.nn.functional.one_hot(y.long(), C).to(torch.float32)
        # _EPS: see the binary fit
        w_sum = torch.clamp_min(maybe_psum(w.sum(-1), axis_name), _EPS)
        with fp32_matmul():
            prior = torch.clamp(maybe_psum(w @ yf32, axis_name)
                                / w_sum[:, None], 1e-6, 1.0)
        f0 = torch.log(prior)                                # (R, C)
        trees = self._class_prepared(prepared, C)
        F = f0[:, None, :].expand(R, n, C)
        feats, thrs, gains, leaves, losses = [], [], [], [], []
        for m in range(self.n_rounds):
            with telemetry.span("boost_round", round=m):
                p = torch.softmax(F, dim=-1)                 # (R, n, C)
                h_unit = torch.clamp_min(p * (1.0 - p), _HESS_FLOOR)
                key_m = prng.fold_in(keys, m) if keys is not None else None
                keep = self._round_row_mask(key_m, n, axis_name)
                wr = w if keep is None else w * keep
                h = (wr[..., None] * h_unit).transpose(1, 2)  # (R, C, n)
                z = ((yf32 - p) / h_unit).transpose(1, 2)
                S = torch.stack([h, h * z, h * z * z], dim=-1).reshape(
                    R * C, n, 3)
                # class keys under their own tag, so a class index never
                # collides with the row mask's fold
                keys_c = None
                if key_m is not None:
                    keys_c = prng.fold_in(
                        prng.fold_in(key_m, _CLASS_TAG)[:, None, :],
                        torch.arange(C, device=key_m.device),
                    ).reshape(R * C, 2)
                feat, thr, gain, node, _ = self._grow(
                    X, S, trees, keys_c, axis_name=axis_name)
                leaf = self._newton_leaf(
                    self._leaf_stats(node, S, axis_name))      # (R·C, L)
                upd = leaf.gather(1, node.long()).reshape(R, C, n)
                F = F + self.lr * upd.transpose(1, 2)
                logp = torch.log_softmax(F, dim=-1)
                nll = -(yf32 * logp).sum(-1)
                losses.append(
                    maybe_psum((w * nll).sum(-1), axis_name) / w_sum)
                feats.append(feat.reshape(R, -1))
                thrs.append(thr.reshape(R, -1))
                gains.append(gain.reshape(R, -1))
                leaves.append(leaf.reshape(R, C, -1))
        self._count_rounds(R * C)
        curve = torch.stack(losses, dim=1)
        new = {
            "f0": f0,
            "feature": torch.cat(feats, dim=1),
            "threshold": torch.cat(thrs, dim=1),
            "gain": torch.cat(gains, dim=1).to(torch.float32),
            "leaf": torch.stack(leaves, dim=1).to(torch.float32),
        }
        return new, {"loss": curve[:, -1], "loss_curve": curve}

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        if params["leaf"].dim() == 3:  # binary: the scalar-margin engine
            return super().fit(params, X, y, sample_weight, keys,
                               prepared=prepared, axis_name=axis_name)
        self._validate_fit_key(keys)
        F = X.shape[-1] if prepared is None or "cols" not in prepared \
            else prepared["cols"].shape[-1]
        if keys is None and self._n_split_features(F) is not None:
            raise ValueError(
                "feature_subset per-split sampling needs the replica "
                "fit key; fit was called with key=None"
            )
        if prepared is None:
            prepared = self.prepare(X, axis_name=axis_name)
        return self._fit_multiclass(
            params, X, y, sample_weight.to(torch.float32), keys, prepared,
            axis_name)

    def _margin_multiclass(self, params, X, cols=None):
        M = 2**self.max_depth - 1
        f0, leaves = params["f0"], params["leaf"]        # (R, rounds, C, L)
        R, _, C, L = leaves.shape
        n = X.shape[-2]
        cols_c = None if cols is None else cols.repeat_interleave(C, dim=0)
        acc = f0[:, None, :].expand(R, n, C)
        for m in range(leaves.shape[1]):
            rnd = {k: params[k][:, m * C * M:(m + 1) * C * M].reshape(
                       R * C, M) for k in ("feature", "threshold")}
            rel = self._route(rnd, X, cols_c)            # (R·C, n)
            upd = leaves[:, m].reshape(R * C, L).gather(1, rel)
            acc = acc + self.lr * upd.reshape(R, C, n).transpose(1, 2)
        return acc

    def _init_margin(self, y, w, w_sum, axis_name=None):
        p = torch.clamp(maybe_psum((w * y).sum(-1), axis_name) / w_sum,
                        1e-6, 1 - 1e-6)
        return torch.log(p / (1.0 - p))

    def _pseudo(self, y, F, w):
        p = torch.sigmoid(F)
        h_unit = torch.clamp_min(p * (1.0 - p), _HESS_FLOOR)
        return w * h_unit, (y - p) / h_unit

    def _round_loss(self, y, F, w, w_sum, axis_name=None):
        # weighted mean logistic loss: softplus(F) - y F
        softplus = torch.logaddexp(F, torch.zeros_like(F))
        return maybe_psum((w * (softplus - y * F)).sum(-1),
                          axis_name) / w_sum

    def predict_scores(self, params, X, cols=None):
        if params["leaf"].dim() == 4:
            return self._margin_multiclass(params, X, cols)
        m = self._margin(params, X, cols)
        return torch.stack([torch.zeros_like(m), m], dim=-1)
