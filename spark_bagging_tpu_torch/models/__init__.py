"""Base learners, batched over a leading replica axis (models/base.py).

Every learner family of the JAX package: :class:`LogisticRegression`
(Newton or Adam), :class:`LinearRegression` (weighted ridge normal
equations), :class:`LinearSVC` (squared hinge, damped Newton), the naive
Bayes learners :class:`GaussianNB`, :class:`MultinomialNB` and
:class:`BernoulliNB`, :class:`GeneralizedLinearRegression` (IRLS), the
factorization machines :class:`FMClassifier` and :class:`FMRegressor`,
:class:`IsotonicRegression` (binned minimax),
:class:`AFTSurvivalRegression` (Weibull AFT with the censor column as
the per-row aux channel), the depth-bounded trees
:class:`DecisionTreeClassifier` and :class:`DecisionTreeRegressor`, the
gradient-boosted trees :class:`GBTClassifier` and :class:`GBTRegressor`,
and the one-hidden-layer MLPs :class:`MLPClassifier` and
:class:`MLPRegressor`.
"""

from spark_bagging_tpu_torch.models.aft import AFTSurvivalRegression
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.fm import FMClassifier, FMRegressor
from spark_bagging_tpu_torch.models.gbt import GBTClassifier, GBTRegressor
from spark_bagging_tpu_torch.models.glm import GeneralizedLinearRegression
from spark_bagging_tpu_torch.models.isotonic import IsotonicRegression
from spark_bagging_tpu_torch.models.linear import LinearRegression
from spark_bagging_tpu_torch.models.logistic import LogisticRegression
from spark_bagging_tpu_torch.models.mlp import MLPClassifier, MLPRegressor
from spark_bagging_tpu_torch.models.naive_bayes import (
    BernoulliNB,
    GaussianNB,
    MultinomialNB,
)
from spark_bagging_tpu_torch.models.svm import LinearSVC
from spark_bagging_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)

__all__ = [
    "AFTSurvivalRegression",
    "BaseLearner",
    "BernoulliNB",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "FMClassifier",
    "FMRegressor",
    "GBTClassifier",
    "GBTRegressor",
    "GaussianNB",
    "GeneralizedLinearRegression",
    "IsotonicRegression",
    "LinearRegression",
    "LinearSVC",
    "LogisticRegression",
    "MLPClassifier",
    "MLPRegressor",
    "MultinomialNB",
]
