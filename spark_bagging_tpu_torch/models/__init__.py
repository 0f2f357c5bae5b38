"""Base learners, batched over a leading replica axis (models/base.py).

Ported so far: :class:`LogisticRegression` (Newton solver) and the
depth-bounded trees :class:`DecisionTreeClassifier` and
:class:`DecisionTreeRegressor`. The other learner families of the JAX
package are queued in ROADMAP.md.
"""

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.logistic import LogisticRegression
from spark_bagging_tpu_torch.models.tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
)

__all__ = [
    "BaseLearner",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "LogisticRegression",
]
