"""Random forests: bagged trees with per-split feature sampling.

A random forest is the bagging loop with a ``featureSubsetStrategy``
drawn per split (Spark ML), so ``RandomForestClassifier`` is
``BaggingClassifier`` whose base learner is a decision tree built from
the estimator's own tree parameters, with ``feature_subset`` doing the
per-split draw (models/tree.py). Defaults follow Spark's
``featureSubsetStrategy="auto"``: the square root of the feature count.
``RandomForestRegressor`` waits for ``BaggingRegressor`` (ROADMAP
Queue A 10).
"""

from __future__ import annotations

from spark_bagging_tpu_torch.bagging import BaggingClassifier
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.tree import DecisionTreeClassifier


class RandomForestClassifier(BaggingClassifier):
    """Bagged Gini trees with per-split feature sampling.

    Tree hyperparameters (``max_depth``, ``n_bins``, ``leaf_smoothing``,
    ``feature_subset``, ``split_impl``, ...) live on this estimator, so
    ``get_params``/``set_params`` tune them directly; the tree learner is
    built from them at fit time.
    """

    def __init__(
        self,
        n_estimators: int = 100,
        max_depth: int = 5,
        n_bins: int = 32,
        feature_subset: str | float | int | None = "sqrt",
        leaf_smoothing: float = 1.0,
        split_impl: str = "auto",
        criterion: str = "gini",
        min_info_gain: float = 0.0,
        min_instances_per_node: float = 0.0,
        max_samples: float | int = 1.0,
        bootstrap: bool = True,
        voting: str = "soft",
        oob_score: bool = False,
        seed: int = 0,
        chunk_size: int | None = None,
        mesh=None,
        warm_start: bool = False,
        device: str = "cuda",
    ):
        super().__init__(
            base_learner=None,
            n_estimators=n_estimators,
            max_samples=max_samples,
            bootstrap=bootstrap,
            voting=voting,
            oob_score=oob_score,
            seed=seed,
            chunk_size=chunk_size,
            mesh=mesh,
            warm_start=warm_start,
            device=device,
        )
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.feature_subset = feature_subset
        self.leaf_smoothing = leaf_smoothing
        self.split_impl = split_impl
        self.criterion = criterion
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node

    def _learner(self) -> BaseLearner:
        return DecisionTreeClassifier(
            max_depth=self.max_depth,
            n_bins=self.n_bins,
            leaf_smoothing=self.leaf_smoothing,
            split_impl=self.split_impl,
            feature_subset=self.feature_subset,
            criterion=self.criterion,
            min_info_gain=self.min_info_gain,
            min_instances_per_node=self.min_instances_per_node,
        )
