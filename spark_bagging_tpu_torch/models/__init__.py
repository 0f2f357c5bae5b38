"""Base learners, batched over a leading replica axis (models/base.py).

Ported so far: :class:`LogisticRegression` (Newton solver),
:class:`LinearRegression` (weighted ridge normal equations), the
depth-bounded trees :class:`DecisionTreeClassifier` and
:class:`DecisionTreeRegressor`, the gradient-boosted trees
:class:`GBTClassifier` and :class:`GBTRegressor`, and the one-hidden-layer
MLPs :class:`MLPClassifier` and :class:`MLPRegressor` (Adam). The other
learner families of the JAX package are queued in ROADMAP.md.
"""

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.gbt import GBTClassifier, GBTRegressor
from spark_bagging_tpu_torch.models.linear import LinearRegression
from spark_bagging_tpu_torch.models.logistic import LogisticRegression
from spark_bagging_tpu_torch.models.mlp import MLPClassifier, MLPRegressor
from spark_bagging_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)

__all__ = [
    "BaseLearner",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "GBTClassifier",
    "GBTRegressor",
    "LinearRegression",
    "LogisticRegression",
    "MLPClassifier",
    "MLPRegressor",
]
