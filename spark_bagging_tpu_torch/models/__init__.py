"""Base learners, batched over a leading replica axis (models/base.py).

Ported so far: :class:`LogisticRegression` (Newton solver). The other
learner families of the JAX package are queued in ROADMAP.md.
"""

from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.models.logistic import LogisticRegression

__all__ = ["BaseLearner", "LogisticRegression"]
