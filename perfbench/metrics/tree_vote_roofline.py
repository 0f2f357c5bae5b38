"""The tree-vote kernel's share of its roofline in a predict call: the
least time of a call's hard vote by a bag of decision-tree classifiers
over the device time of the operations launched inside the program's
``tree_vote`` profiler range (the port's ops/tree_vote.py
``TREE_VOTE_RANGE``, which holds the kernel and the wrapper's tables),
found by the range's name, so the share reads the same work whatever
implements it.

The least time is the larger of the call's bytes at the card's
bandwidth and its compares on the fp32 cores: X (m rows of the
configuration's features), each tree's nodes (a column and a threshold,
8 bytes) and leaf log-probabilities, and the (m, C) counts, each once;
m R D compares. A program without the range (before the kernel) reads
nothing, as does a configuration of another learner."""

from counts import peaks


def least_seconds(config) -> float | None:
    """The least time of one call, or None for a configuration that is
    not a bag of decision-tree classifiers."""
    est = config.get("estimator", {})
    learner = est.get("learner", {})
    if learner.get("class") != "DecisionTreeClassifier":
        return None
    data = config["data"]
    m, F, C = data["n_predict_rows"], data["n_features"], data["n_classes"]
    R = est["params"]["n_estimators"]
    D = learner["params"]["max_depth"]
    nbytes = (4.0 * m * F + 8.0 * R * (2 ** D - 1) + 4.0 * R * 2 ** D * C
              + 4.0 * m * C)
    return max(nbytes / peaks.BYTES, m * R * D / peaks.FP32)


def read(run):
    if not run.calls:
        return None
    t = run.trace.seconds_under_range("tree_vote")
    least = least_seconds(run.config)
    if not t or least is None:
        return None
    return 100.0 * least * len(run.calls) / t
