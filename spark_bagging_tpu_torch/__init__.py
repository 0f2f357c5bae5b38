"""spark_bagging_tpu_torch: the PyTorch/CUDA port of spark_bagging_tpu.

Bagging ensembles on an NVIDIA H100: Poisson-bootstrap replicas fitted
together along a replica axis, soft or hard votes, and hand-written
Hopper kernels (``csrc/``) for the hot loops the JAX package wrote in
Pallas: the scaled-Gram Hessian of logistic regression and the
split-search histogram of decision trees, random forests and
gradient-boosted trees. The classifiers vote; the regressors (bagged
ridge regression, bagged regression trees and boosted trees, random
forests) average. ``fit_stream`` fits out of core from a chunk source:
SGD learners (the MLPs, logistic and ridge regression) by Adam over
the chunks, trees by a multi-pass level-synchronous growth. The JAX
package stays the reference this port is held against; the port
imports only torch and numpy.

Entry points run on the card (``device="cuda"``, the default) and raise
where CUDA is absent; ``device="cpu"`` must be asked for.
"""

from spark_bagging_tpu_torch.bagging import BaggingClassifier, BaggingRegressor
from spark_bagging_tpu_torch.forest import (
    RandomForestClassifier,
    RandomForestRegressor,
)
from spark_bagging_tpu_torch.models import (
    BaseLearner,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GBTClassifier,
    GBTRegressor,
    LinearRegression,
    LogisticRegression,
    MLPClassifier,
    MLPRegressor,
)

__version__ = "0.2.0"

__all__ = [
    "BaggingClassifier",
    "BaggingRegressor",
    "BaseLearner",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "GBTClassifier",
    "GBTRegressor",
    "LinearRegression",
    "LogisticRegression",
    "MLPClassifier",
    "MLPRegressor",
    "RandomForestClassifier",
    "RandomForestRegressor",
]
