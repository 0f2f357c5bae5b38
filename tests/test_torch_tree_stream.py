"""The port's streamed tree engine (tree_stream.py) and its per-chunk
step (``_TreeBase._chunk_level_hist``) against the JAX package.

Both packages stream the same numpy chunks (700 rows in chunks of 256:
the last padded), draw bitwise equal chunk-keyed weights and feature
masks, and average the same per-chunk quantile edges.

- Gini trees: integer statistics, summed exactly in float32 (below
  2**24) in any order, so ``feature``, ``threshold`` and ``gain`` are
  bitwise JAX's; ``leaf_logp`` within 2 ulps (XLA's float32 ``log`` and
  torch's differ in the last bit, as for in-memory trees).
- Regression forests: float moments (w, w y, w y^2) summed in another
  order. Splits and leaf values equal; gains within GAIN_RTOL (1e-5)
  of the largest gain (found: 1.5e-5 absolute on gains up to ~40, a
  relative 3.8e-7).
- ``_chunk_level_hist``: on integer statistics bitwise equal to the
  JAX package's (its Pallas kernel run in interpret mode, as
  tests/test_hist.py runs it), on float statistics within 1e-6 of the
  largest entry.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.models import tree as jtree  # noqa: E402
from spark_bagging_tpu.utils import io as jio  # noqa: E402
from spark_bagging_tpu_torch import tree_stream  # noqa: E402
from spark_bagging_tpu_torch.models import tree as ttree  # noqa: E402
from spark_bagging_tpu_torch.ops import bootstrap as tboot  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tdata  # noqa: E402
from spark_bagging_tpu_torch.utils import io as tio  # noqa: E402

N, CHUNK = 700, 256
TREE = dict(max_depth=3, n_bins=16)
EST = dict(n_estimators=4, seed=3)
LOGP_ULPS = 2
GAIN_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU fits here take one intra-op thread: under xdist each
    worker's default pool takes every core of the host and the workers'
    pools spin against one another (tests/test_torch_stream.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("max_features,feature_subset", [
    (1.0, None), (0.8, None), (0.8, "sqrt"),
])
def test_streamed_gini_trees_bitwise_equal_to_jax(max_features,
                                                  feature_subset):
    X, y = tdata.make_classification(N, 6, 3, seed=0)
    kw = dict(TREE, feature_subset=feature_subset)
    est = dict(EST, max_features=max_features, voting="hard", oob_score=True)
    jf = J.BaggingClassifier(J.DecisionTreeClassifier(**kw), **est) \
        .fit_stream(jio.ArrayChunks(X, y, CHUNK), prefetch=0)
    tf = T.BaggingClassifier(T.DecisionTreeClassifier(**kw), device="cpu",
                             **est).fit_stream(tio.ArrayChunks(X, y, CHUNK))
    for k in ("feature", "threshold", "gain"):
        np.testing.assert_array_equal(tf.ensemble_[k].numpy(),
                                      np.asarray(jf.ensemble_[k]), err_msg=k)
    assert _ulps(jf.ensemble_["leaf_logp"],
                 tf.ensemble_["leaf_logp"].numpy()) <= LOGP_ULPS
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    np.testing.assert_array_equal(tf.predict(X), jf.predict(X))
    assert tf.oob_score_ == jf.oob_score_
    rep = tf.fit_report_
    assert (rep["n_chunks"], rep["n_passes"]) == (3, TREE["max_depth"] + 2)
    np.testing.assert_allclose(tf.feature_importances_,
                               jf.feature_importances_, atol=1e-7)


def test_streamed_regression_forest_matches_jax():
    X, y = tdata.make_regression(N, 6, seed=0)
    kw = dict(max_depth=3, n_bins=16, n_estimators=4, seed=3)
    jf = J.RandomForestRegressor(**kw).fit_stream(
        jio.ArrayChunks(X, y, CHUNK), prefetch=0)
    tf = T.RandomForestRegressor(device="cpu", **kw).fit_stream(
        tio.ArrayChunks(X, y, CHUNK))
    for k in ("feature", "threshold", "leaf_value"):
        np.testing.assert_array_equal(tf.ensemble_[k].numpy(),
                                      np.asarray(jf.ensemble_[k]), err_msg=k)
    jg = np.asarray(jf.ensemble_["gain"])
    np.testing.assert_allclose(tf.ensemble_["gain"].numpy(), jg,
                               atol=GAIN_RTOL * jg.max(), rtol=0)
    np.testing.assert_array_equal(tf.predict(X), jf.predict(X))


def test_one_chunk_stream_is_the_in_memory_fit_on_its_weights():
    # one chunk covering every row: the stream's edges are the in-memory
    # quantile edges and its weights the chunk-keyed draw, so the trees
    # are the in-memory fit's on those weights, bit for bit
    X, y = tdata.make_classification(300, 5, 3, seed=4)
    learner = T.DecisionTreeClassifier(**TREE)
    key = prng.key(9)
    params, subs, _ = tree_stream.fit_tree_ensemble_stream(
        learner, tio.ArrayChunks(X, y, 300), key, 3, 3)
    ids = torch.arange(3)
    _, ck = tree_stream.chunk_context(
        prng.fold_in(key, tree_stream._CHUNK_STREAM), 0, 300, 300)
    w = tboot.bootstrap_weights(ck, ids, 300)
    init_keys, fit_keys = tboot.replica_init_fit_keys(key, ids)
    Xt = torch.from_numpy(X)
    want, _ = learner.fit(learner.init_params(init_keys, 5, 3), Xt,
                          torch.from_numpy(y), w, fit_keys)
    for k in want:
        assert torch.equal(params[k], want[k]), k


@pytest.mark.parametrize("integral", [True, False])
def test_chunk_level_hist_matches_jax(integral):
    rng = np.random.default_rng(0)
    n, F_all, F, B, N_nodes, K, R = 64, 6, 4, 8, 2, 3, 3
    X = rng.standard_normal((n, F_all)).astype(np.float32)
    X[:5, 1] = np.nan
    edges = np.sort(rng.standard_normal((F_all, B)).astype(np.float32), 1)
    edges[:, -1] = np.inf
    cols = np.stack([rng.permutation(F_all)[:F] for _ in range(R)])
    node = rng.integers(0, N_nodes, (R, n)).astype(np.int32)
    if integral:
        S = rng.integers(0, 4, (R, n, K)).astype(np.float32)
    else:
        S = rng.standard_normal((R, n, K)).astype(np.float32)
    jl = jtree.DecisionTreeClassifier(n_bins=B, split_impl="fused",
                                      hist_dtype="float32")
    want = np.stack([np.asarray(jl._chunk_level_hist(
        jnp.asarray(X[:, cols[r]]), jnp.asarray(S[r]),
        jnp.asarray(edges[cols[r]]), jnp.asarray(node[r]), N_nodes))
        for r in range(R)])
    tl = T.DecisionTreeClassifier(n_bins=B, split_impl="fused")
    got = tl._chunk_level_hist(
        torch.from_numpy(X), torch.from_numpy(S), torch.from_numpy(edges),
        torch.from_numpy(node), N_nodes, cols=torch.from_numpy(cols),
        integral=integral).numpy()
    assert got.shape == (R, F, B, N_nodes, K)
    if integral:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # the dense split search gives the same table
    dense = T.DecisionTreeClassifier(n_bins=B, split_impl="dense")
    np.testing.assert_allclose(
        dense._chunk_level_hist(
            torch.from_numpy(X), torch.from_numpy(S),
            torch.from_numpy(edges), torch.from_numpy(node), N_nodes,
            cols=torch.from_numpy(cols)).numpy(),
        got, rtol=0, atol=0 if integral else 1e-6 * np.abs(want).max())
    # without cols every feature is read
    full = tl._chunk_level_hist(
        torch.from_numpy(X), torch.from_numpy(S), torch.from_numpy(edges),
        torch.from_numpy(node), N_nodes)
    assert full.shape == (R, F_all, B, N_nodes, K)


def test_route_partial_reads_through_the_column_index():
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.standard_normal((50, 6)).astype(np.float32))
    cols = torch.tensor([[4, 0, 2], [1, 5, 3]], dtype=torch.int32)
    feats = [torch.tensor([[1], [2]], dtype=torch.int32),
             torch.tensor([[0, 2], [1, 1]], dtype=torch.int32)]
    thrs = [torch.tensor([[0.1], [-0.2]]), torch.tensor([[0.0, 0.5],
                                                         [0.3, -1.0]])]
    node = tree_stream._route_partial(feats, thrs, X, cols, 2)
    gathered = X[:, cols.long()].permute(1, 0, 2)  # (R, n, 3)
    for r in range(2):
        rel = np.zeros(50, np.int64)
        for f, t in zip(feats, thrs):
            x = gathered[r].numpy()[np.arange(50), f[r].numpy()[rel]]
            rel = rel * 2 + (x > t[r].numpy()[rel])
        np.testing.assert_array_equal(node[r].numpy(), rel)
    assert tree_stream._route_partial([], [], X, cols, 2).shape == (2, 50)
