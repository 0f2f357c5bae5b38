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
average. ``fit_stream`` fits out of core from a chunk source (arrays,
synthetic streams, libsvm, CSV, hashed-categorical CSV or Arrow files;
the text readers parse through a g++-built host loader): SGD
learners by Adam over the chunks (the survival learner's censor flags
as a streamed column, ``aux_col``), trees by a multi-pass
level-synchronous growth, with snapshots to resume from; ``warm_start``
grows a fitted ensemble; ``online.OnlineUpdater`` applies streaming
Poisson-weight ``partial_fit`` steps to a fitted one. ``save``/``load`` (and ``save_model``/
``load_model``) write and read the JAX package's checkpoint format. ``serving`` is the online plane: one CUDA
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
from spark_bagging_tpu_torch.utils.arrow import ArrowChunks
from spark_bagging_tpu_torch.utils.checkpoint import load_model, save_model
from spark_bagging_tpu_torch.utils.hashing import (
    FeatureHasher,
    HashedCSVChunks,
)
from spark_bagging_tpu_torch.utils.io import (
    ArrayChunks,
    ChunkSource,
    CSVChunks,
    LibsvmChunks,
    SyntheticChunks,
)

__version__ = "0.3.0"

__all__ = [
    "AFTSurvivalRegression",
    "ArrayChunks",
    "ArrowChunks",
    "BaggingClassifier",
    "BaggingRegressor",
    "BaseLearner",
    "BernoulliNB",
    "CSVChunks",
    "ChunkSource",
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "FMClassifier",
    "FMRegressor",
    "FeatureHasher",
    "GBTClassifier",
    "GBTRegressor",
    "GaussianNB",
    "GeneralizedLinearRegression",
    "HashedCSVChunks",
    "IsotonicRegression",
    "LibsvmChunks",
    "LinearRegression",
    "LinearSVC",
    "LogisticRegression",
    "MLPClassifier",
    "MLPRegressor",
    "MultinomialNB",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "SyntheticChunks",
    "load_model",
    "save_model",
    "serving",
    "telemetry",
]
