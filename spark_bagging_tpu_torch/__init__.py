"""spark_bagging_tpu_torch: the PyTorch/CUDA port of spark_bagging_tpu.

Bagging ensembles on an NVIDIA H100: Poisson-bootstrap replicas fitted
together along a replica axis, soft or hard votes, and hand-written
Hopper kernels (``csrc/``) for the hot loops the JAX package wrote in
Pallas: the scaled-Gram Hessian of logistic regression and the
split-search histogram of decision trees, random forests and
gradient-boosted trees. Every learner family of the JAX package is
here (models/): logistic regression, linear SVM, naive Bayes, ridge,
GLM, factorization machines, isotonic and AFT survival regression,
trees, forests, GBTs and MLPs. The classifiers vote; the regressors
average. ``fit_stream`` fits out of core from a chunk source: SGD
learners by Adam over the chunks (the survival learner's censor flags
as a streamed column, ``aux_col``), trees by a multi-pass
level-synchronous growth. ``save``/``load`` write and read the JAX
package's checkpoint format. ``serving`` is the online plane: one CUDA
graph a row bucket (``EnsembleExecutor``), a micro-batcher and a model
registry with hot swap. The JAX package stays the reference this port
is held against; the port imports only torch and numpy.

Entry points run on the card (``device="cuda"``, the default) and raise
where CUDA is absent; ``device="cpu"`` must be asked for.
"""

from spark_bagging_tpu_torch import serving, telemetry
from spark_bagging_tpu_torch.bagging import BaggingClassifier, BaggingRegressor
from spark_bagging_tpu_torch.forest import (
    RandomForestClassifier,
    RandomForestRegressor,
)
from spark_bagging_tpu_torch.models import (
    AFTSurvivalRegression,
    BaseLearner,
    BernoulliNB,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    FMClassifier,
    FMRegressor,
    GaussianNB,
    GBTClassifier,
    GBTRegressor,
    GeneralizedLinearRegression,
    IsotonicRegression,
    LinearRegression,
    LinearSVC,
    LogisticRegression,
    MLPClassifier,
    MLPRegressor,
    MultinomialNB,
)

__version__ = "0.3.0"

__all__ = [
    "AFTSurvivalRegression",
    "BaggingClassifier",
    "BaggingRegressor",
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
    "RandomForestClassifier",
    "RandomForestRegressor",
    "serving",
    "telemetry",
]
