"""The tree-vote kernel (ops/tree_vote.py, csrc/tree_vote.cu) and the
batch forward's dispatch to it.

CPU (tier-1): the plain version is the torch chain it replaces, bit for
bit, through ``predict_ensemble_classifier``; the kernel's tables walked
as the kernel walks them (a numpy walker) give the chain's counts bit
for bit, at every depth up to ``MAX_DEPTH``, 2 to ``MAX_CLASSES``
classes, subspaces through ``cols`` and the identity subspace, values
equal to a threshold, NaN and infinities in X, thresholds at +-inf and
leaves whose log-probabilities tie or hold a NaN; a replica-axis sum
over two halves; the chain untouched where the kernel does not take
the vote; the launch geometry. (The dispatch rule and the kernel's
build and C interface: tests/test_torch_kernels.py.)

Card (``cuda`` marker, skipped here with "no CUDA device"; the file
imports no JAX, so on the card run
``python -m pytest --noconftest -m cuda tests/test_torch_tree_vote.py``):
the kernel against the plain version bit for bit at config 3's shapes,
at ragged row counts, for bags split over stages, for X too wide to
stage, at every class-word count; through a captured CUDA graph's
replay; launches per forward; replica-sharded serving of a hard vote,
a launch a shard, bit for bit the single-device forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_bagging_tpu_torch import (  # noqa: E402
    BaggingClassifier,
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    GBTClassifier,
    LogisticRegression,
    RandomForestClassifier,
)
from spark_bagging_tpu_torch.ensemble import (  # noqa: E402
    predict_ensemble_classifier,
    predict_scores_ensemble,
)
from spark_bagging_tpu_torch.ops import tree_vote as tv  # noqa: E402
from spark_bagging_tpu_torch.ops.aggregate import mean_aggregate  # noqa: E402
from spark_bagging_tpu_torch.ops.tree_vote import (  # noqa: E402
    MAX_CLASSES,
    MAX_DEPTH,
    kernel_geometry,
    tree_tables,
    tree_vote_counts,
    tree_vote_counts_plain,
)
from spark_bagging_tpu_torch.utils.datasets import make_classification  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _bag(R, depth, C, F, k=None, n=257, seed=0, device="cpu"):
    """A bag of ``R`` random depth-``depth`` trees over ``F`` columns (a
    ``k``-column subspace each where ``k`` is set) and ``n`` rows. X and
    the thresholds lie on a grid of quarters, so rows meet thresholds
    exactly; X holds NaN and +-inf, a few thresholds are +-inf, leaf
    log-probabilities are small integers (ties in most leaves) and a few
    are NaN. Returns ``(X, params, cols)``."""
    rng = np.random.default_rng(seed)
    X = (np.round(rng.standard_normal((n, F)) * 4) / 4).astype(np.float32)
    u = rng.random((n, F))
    X[u < 0.03] = np.nan
    X[(u >= 0.03) & (u < 0.05)] = np.inf
    X[(u >= 0.05) & (u < 0.07)] = -np.inf
    M, L = 2 ** depth - 1, 2 ** depth
    width = k if k is not None else F
    thr = (np.round(rng.standard_normal((R, M)) * 4) / 4).astype(np.float32)
    v = rng.random((R, M))
    thr[v < 0.02] = np.inf
    thr[(v >= 0.02) & (v < 0.04)] = -np.inf
    logp = rng.integers(-3, 0, (R, L, C)).astype(np.float32)
    logp[rng.random((R, L, C)) < 0.01] = np.nan
    params = {
        "feature": torch.from_numpy(
            rng.integers(0, width, (R, M)).astype(np.int32)),
        "threshold": torch.from_numpy(thr),
        "gain": torch.zeros((R, M)),
        "leaf_logp": torch.from_numpy(logp),
    }
    cols = (torch.from_numpy(np.stack(
        [rng.choice(F, width, replace=False) for _ in range(R)]
    ).astype(np.int32)) if k is not None
        else torch.arange(F, dtype=torch.int32).expand(R, F).contiguous())
    dev = torch.device(device)
    return (torch.from_numpy(X).to(dev),
            {key: t.to(dev) for key, t in params.items()}, cols.to(dev))


def _walk(X, nodes, leaf, C) -> np.ndarray:
    """The kernel's walk over its tables, in numpy: each tree's heap of
    (column, threshold bits) nodes, ``rel = 2 rel + (x > t)`` a level,
    one vote for the leaf's class."""
    X = X.numpy()
    nodes, leaf = nodes.numpy(), leaf.numpy()
    col, thr = nodes[..., 0], nodes[..., 1].view(np.float32)
    n, (R, M) = X.shape[0], col.shape
    rows = np.arange(n)
    counts = np.zeros((n, C), dtype=np.float32)
    for r in range(R):
        rel, off = np.zeros(n, dtype=np.int64), 0
        while off < M:
            node = off + rel
            with np.errstate(invalid="ignore"):
                rel = 2 * rel + (X[rows, col[r, node]] > thr[r, node])
            off = 2 * off + 1
        np.add.at(counts, (rows, leaf[r, rel]), 1.0)
    return counts


_DEPTH_CLASSES = list(zip(range(1, MAX_DEPTH + 1),
                          [2, 3, 5, 7, 8, 9, 15, 16, 17, 24, 31, MAX_CLASSES]))


# -- CPU -----------------------------------------------------------------

@pytest.mark.parametrize("subspace", ["identity", "cols"])
@pytest.mark.parametrize("depth, C", _DEPTH_CLASSES)
def test_plain_and_the_kernels_walk_are_the_chain_bit_for_bit(depth, C,
                                                              subspace):
    R, F = 5, 11
    k = None if subspace == "identity" else 7
    X, params, cols = _bag(R, depth, C, F, k=k, seed=depth * 100 + C)
    learner = DecisionTreeClassifier(max_depth=depth)
    use = None if k is None else cols
    plain = tree_vote_counts_plain(learner, params, X, C, use)
    assert plain.dtype == torch.float32 and plain.shape == (X.shape[0], C)
    assert float(plain.sum()) == R * X.shape[0]
    chain = predict_ensemble_classifier(
        learner, params, cols, X, C, R, voting="hard", chunk_size=2,
        identity_subspace=k is None)
    assert torch.equal(mean_aggregate(plain[None], n_total=R), chain)
    nodes, leaf = tree_tables(params["feature"], params["threshold"],
                              params["leaf_logp"], depth, use)
    assert nodes.dtype == torch.int32 and nodes.shape == (R, 2 ** depth - 1, 2)
    assert leaf.dtype == torch.uint8 and leaf.shape == (R, 2 ** depth)
    assert torch.equal(torch.from_numpy(_walk(X, nodes, leaf, C)), plain)


def test_replica_axis_sum_over_two_halves_is_the_whole_bag():
    from spark_bagging_tpu_torch.parallel import make_mesh
    from spark_bagging_tpu_torch.parallel.sharded import (
        sharded_predict_classifier,
    )

    R, depth, C, F = 8, 4, 5, 9
    X, params, cols = _bag(R, depth, C, F, k=6, seed=3, n=64)
    learner = DecisionTreeClassifier(max_depth=depth)
    halves = torch.stack([
        tree_vote_counts_plain(
            learner, {key: t[s] for key, t in params.items()}, X, C, cols[s])
        for s in (slice(0, 4), slice(4, 8))])
    whole = predict_ensemble_classifier(learner, params, cols, X, C, R,
                                        voting="hard")
    assert torch.equal(mean_aggregate(halves, n_total=R), whole)
    mesh = make_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    sharded = sharded_predict_classifier(learner, mesh, params, cols, X, C, R,
                                         voting="hard")
    assert torch.equal(sharded, whole)


def test_only_the_tree_classifier_declares_its_leaf_table():
    from spark_bagging_tpu_torch import GBTRegressor, LinearSVC, MLPClassifier

    assert DecisionTreeClassifier.tree_leaf_scores == "leaf_logp"
    for cls in (DecisionTreeRegressor, GBTClassifier, GBTRegressor,
                LogisticRegression, LinearSVC, MLPClassifier):
        assert cls.tree_leaf_scores is None


@pytest.mark.parametrize("case", ["trees_hard", "trees_soft", "forest",
                                  "gbt_hard"])
def test_cpu_forwards_keep_the_chain_and_launch_nothing(case):
    X, y = make_classification(240, 6, 3, seed=2)
    learner = (GBTClassifier(n_rounds=2, max_depth=3, n_bins=16)
               if case == "gbt_hard"
               else DecisionTreeClassifier(max_depth=3, n_bins=16))
    voting = "soft" if case == "trees_soft" else "hard"
    if case == "forest":
        clf = RandomForestClassifier(n_estimators=5, max_depth=3, n_bins=16,
                                     device="cpu").fit(X, y)
        voting = clf.voting
    else:
        clf = BaggingClassifier(learner, n_estimators=5, max_features=0.8,
                                voting=voting, device="cpu").fit(X, y)
    before = tree_vote_counts.launches
    got = clf.predict_proba(X)
    assert tree_vote_counts.launches == before
    scores = predict_scores_ensemble(
        clf._fitted_learner, clf.ensemble_, clf.subspaces_,
        torch.from_numpy(X), identity_subspace=clf._identity_subspace)
    if voting == "hard":
        votes = torch.nn.functional.one_hot(scores.argmax(-1), 3).float()
    else:
        votes = torch.softmax(scores, dim=-1)
    want = (votes.sum(dim=0) / 5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if voting == "hard":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, F, C, R, depth, n_sm, want", [
    # predict.covtype_trees: every tree in one stage, a block an SM
    (581_012, 54, 7, 256, 5, 132,
     dict(staged=True, per_stage=256, stages=1, row_tiles=4540, blocks=132,
          smem=130_560, accumulate=False)),
    # one row: one block
    (1, 54, 7, 256, 5, 132,
     dict(staged=True, per_stage=256, stages=1, row_tiles=1, blocks=1,
          smem=130_560, accumulate=False)),
    # X too wide to stage is read from device memory
    (10_000, 200, 2, 64, 5, 132,
     dict(staged=False, per_stage=64, stages=1, row_tiles=79, blocks=79,
          smem=18_944, accumulate=False)),
    # deep trees: four a stage beside the staged X
    (10_000, 54, 32, 10, MAX_DEPTH, 132,
     dict(staged=True, per_stage=4, stages=3, row_tiles=79, blocks=44,
          smem=219_104, accumulate=True)),
])
def test_kernel_geometry(n, F, C, R, depth, n_sm, want):
    assert kernel_geometry(n, F, C, R, depth, n_sm) == want


@pytest.mark.parametrize("n", [1, 127, 129, 50_000, 581_012])
@pytest.mark.parametrize("F", [1, 54, 113, 114, 2000])
@pytest.mark.parametrize("depth, C, R", [(1, 2, 1), (5, 7, 256),
                                         (8, 17, 1000), (MAX_DEPTH, 32, 37)])
def test_geometry_covers_the_bag_within_shared_memory(n, F, C, R, depth):
    g = kernel_geometry(n, F, C, R, depth, 132)
    assert g["smem"] <= tv.SMEM_BYTES
    assert g["per_stage"] >= 1 and g["per_stage"] * g["stages"] >= R
    assert (g["stages"] - 1) * g["per_stage"] < R
    assert 1 <= g["blocks"] <= g["row_tiles"]
    assert g["accumulate"] == (g["stages"] > 1)
    assert g["staged"] == (F <= 113)


def test_kernel_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="depth"):
        kernel_geometry(10, 4, 2, 2, MAX_DEPTH + 1, 132)
    with pytest.raises(ValueError, match="classes"):
        kernel_geometry(10, 4, MAX_CLASSES + 1, 2, 5, 132)


def test_tree_vote_counts_checks_its_inputs():
    X, params, cols = _bag(3, 3, 4, 6)
    args = (params["feature"], params["threshold"], params["leaf_logp"])
    with pytest.raises(TypeError):
        tree_vote_counts(X.double(), *args, depth=3, n_classes=4)
    with pytest.raises(ValueError):
        tree_vote_counts(X, *args, depth=4, n_classes=4)
    with pytest.raises(ValueError):
        tree_vote_counts(X, *args, depth=3, n_classes=5)
    with pytest.raises(TypeError):
        tree_vote_counts(X, args[0], args[1].double(), args[2], depth=3,
                         n_classes=4)
    with pytest.raises(ValueError, match="kernel"):
        tree_vote_counts(X, *args, depth=3, n_classes=4)  # the card's only


# -- card ----------------------------------------------------------------

def _check_on_card(cuda, R, depth, C, F, k, n, seed):
    X, params, cols = _bag(R, depth, C, F, k=k, n=n, seed=seed, device=cuda)
    learner = DecisionTreeClassifier(max_depth=depth)
    use = None if k is None else cols
    want = tree_vote_counts_plain(learner, params, X, C, use)
    got = tree_vote_counts(X, params["feature"], params["threshold"],
                           params["leaf_logp"], depth=depth, n_classes=C,
                           cols=use)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (n, C)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_at_config3_shapes_is_the_chain_bit_for_bit(cuda):
    # predict.covtype_trees: 581,012 rows, 54 columns, 256 depth-5 trees
    # on 43-column subspaces, 7 classes
    _check_on_card(cuda, 256, 5, 7, 54, 43, 581_012, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 128, 129, 128 * 132 + 1])
def test_kernel_at_ragged_row_counts(cuda, n):
    _check_on_card(cuda, 37, 5, 7, 54, 43, n, seed=n)


@pytest.mark.cuda
@pytest.mark.parametrize("depth, C, R, F", [
    (10, 3, 60, 54),          # 9,208 bytes a tree: stages of 18
    (MAX_DEPTH, 32, 9, 20),   # four words of counters, stages of 5
    (5, 9, 300, 500),         # X too wide to stage: read through L1
    (1, 2, 2100, 3),          # 262 trees a thread: two flushes
    (6, 17, 1000, 54),        # three words of counters
])
def test_kernel_across_stages_widths_and_class_words(cuda, depth, C, R, F):
    _check_on_card(cuda, R, depth, C, F, None, 5_000, seed=depth + C)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 70_000])
def test_kernel_is_bitwise_repeatable_and_through_a_graph(cuda, n):
    X, params, cols = _bag(64, 5, 7, 54, k=43, n=n, seed=9, device=cuda)
    args = (X, params["feature"], params["threshold"], params["leaf_logp"])
    kw = dict(depth=5, n_classes=7, cols=cols)
    first = tree_vote_counts(*args, **kw)
    assert torch.equal(tree_vote_counts(*args, **kw), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tree_vote_counts(*args, **kw)  # the capture's warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = tree_vote_counts.launches
    with torch.cuda.graph(graph):
        captured = tree_vote_counts(*args, **kw)
    assert tree_vote_counts.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("case, launches", [
    # one launch a forward, whatever the replica chunk
    ("trees_hard", 1), ("trees_hard_chunked", 1), ("trees_identity", 1),
    ("trees_soft", 0), ("forest", 0), ("gbt_hard", 0), ("logistic_hard", 0)])
def test_launches_per_forward(cuda, case, launches):
    X, y = make_classification(3000, 12, 4, seed=5)
    learner = {"gbt_hard": GBTClassifier(n_rounds=2, max_depth=3),
               "logistic_hard": LogisticRegression(max_iter=2)}.get(
                   case, DecisionTreeClassifier(max_depth=4))
    opts = {"trees_soft": {"voting": "soft", "max_features": 0.75},
            "trees_hard_chunked": {"voting": "hard", "max_features": 0.75,
                                   "chunk_size": 3},
            "trees_identity": {"voting": "hard"}}.get(
                case, {"voting": "hard", "max_features": 0.75})
    if case == "forest":
        clf = RandomForestClassifier(n_estimators=9, max_depth=4,
                                     device=cuda).fit(X, y)
    else:
        clf = BaggingClassifier(learner, n_estimators=9, device=cuda,
                                **opts).fit(X, y)
    before = tree_vote_counts.launches
    proba = clf.predict_proba(X)
    assert tree_vote_counts.launches == before + launches
    # the card's forward against the CPU chain on the same state
    fn, params, subs = clf.aggregated_forward()
    cpu = fn({k: v.cpu() for k, v in params.items()}, subs.cpu(),
             torch.from_numpy(X))
    if launches:
        np.testing.assert_array_equal(proba, cpu.numpy())


@pytest.mark.cuda
def test_replica_forward_and_oob_keep_the_chain(cuda):
    from spark_bagging_tpu_torch.ensemble import classifier_replica_forward

    X, y = make_classification(2000, 10, 3, seed=6)
    before = tree_vote_counts.launches
    clf = BaggingClassifier(DecisionTreeClassifier(max_depth=4),
                            n_estimators=6, max_features=0.75,
                            voting="hard", oob_score=True,
                            device=cuda).fit(X, y)
    assert tree_vote_counts.launches == before
    fwd = classifier_replica_forward(
        clf._fitted_learner, clf.n_classes_, voting="hard",
        identity_subspace=clf._identity_subspace)
    per = fwd(clf.ensemble_, clf.subspaces_, torch.from_numpy(X).to(cuda))
    assert tree_vote_counts.launches == before
    np.testing.assert_array_equal((per.sum(dim=0) / 6).cpu().numpy(),
                                  clf.predict_proba(X))


@pytest.mark.cuda
def test_mesh_serving_of_a_hard_vote_takes_the_kernel_bitwise(cuda):
    # replica-sharded serving over cuda:0 x 4: each shard's hard vote is
    # one tree-vote launch (ensemble.kernel_vote, as the single-device
    # forward's), and the shards' whole-number counts add up to the
    # single-device forward's bits
    from spark_bagging_tpu_torch import make_mesh
    from spark_bagging_tpu_torch.parallel.sharded import (
        replica_sharded_serving,
    )
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    X, y = make_classification(3000, 12, 4, seed=5)
    clf = BaggingClassifier(DecisionTreeClassifier(max_depth=4),
                            n_estimators=16, voting="hard",
                            max_features=0.75, device=cuda).fit(X, y)
    mesh = make_mesh(replica=4, devices=[cuda] * 4)
    fwd, _rep, params, subs, _dev, shards = replica_sharded_serving(clf, mesh)
    Xt = torch.from_numpy(X).to(cuda)
    before = tree_vote_counts.launches
    got = fwd(params, subs, Xt)
    assert tree_vote_counts.launches == before + shards == before + 4
    np.testing.assert_array_equal(got.cpu().numpy(), clf.predict_proba(X))
    single = EnsembleExecutor(clf, min_bucket_rows=1, max_batch_rows=64)
    sharded = EnsembleExecutor(clf, min_bucket_rows=1, max_batch_rows=64,
                               mesh=mesh)
    single.warmup()
    sharded.warmup()
    for b in (1, 7, 64):
        np.testing.assert_array_equal(sharded.forward(X[:b]),
                                      single.forward(X[:b]))
