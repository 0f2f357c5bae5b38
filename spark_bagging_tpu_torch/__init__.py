"""spark_bagging_tpu_torch: the PyTorch/CUDA port of spark_bagging_tpu.

Bagging ensembles on an NVIDIA H100: Poisson-bootstrap replicas fitted
together along a replica axis, soft or hard votes, and hand-written
Hopper kernels (``csrc/``) for the hot loops the JAX package wrote in
Pallas: the scaled-Gram Hessian of logistic regression and the
split-search histogram of decision trees and random forests. The JAX
package stays the reference this port is held against; the port
imports only torch and numpy.

Entry points run on the card (``device="cuda"``, the default) and raise
where CUDA is absent; ``device="cpu"`` must be asked for.
"""

from spark_bagging_tpu_torch.bagging import BaggingClassifier
from spark_bagging_tpu_torch.forest import RandomForestClassifier
from spark_bagging_tpu_torch.models import (
    BaseLearner,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    LogisticRegression,
)

__version__ = "0.2.0"

__all__ = [
    "BaggingClassifier",
    "BaseLearner",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "LogisticRegression",
    "RandomForestClassifier",
]
