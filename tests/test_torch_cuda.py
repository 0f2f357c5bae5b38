"""The port's CUDA kernels and estimator on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips elsewhere with the reason "no CUDA device". The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.)
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_scaled_gram_kernel_matches_plain(cuda, op_dtype, shared_x):
    from spark_bagging_tpu_torch.ops.gram import (
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(0)
    R, n, d, P = 3, 5000, 55, 28
    X = torch.from_numpy(rng.standard_normal(
        (n, d) if shared_x else (R, n, d)).astype(np.float32)).to(cuda)
    S = torch.from_numpy(
        rng.uniform(-0.3, 1.0, (R, n, P)).astype(np.float32)).to(cuda)
    before = scaled_grams.launches
    out = scaled_grams(X, S, op_dtype=op_dtype)
    again = scaled_grams(X, S, op_dtype=op_dtype)
    torch.cuda.synchronize()
    assert scaled_grams.launches == before + 2
    assert torch.equal(out, again)  # no atomics: runs repeat bitwise
    # fp32 sums of identical operands in another order: ~1e-6 of the
    # largest entry at 5000 rows
    assert _rel_err(out, scaled_grams_plain(X, S, op_dtype=op_dtype)) <= 1e-4


def test_scaled_gram_kernel_single_replica_and_odd_shapes(cuda):
    from spark_bagging_tpu_torch.ops.gram import (
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(1)
    for n, d, P in ((1, 1, 1), (33, 9, 6), (1000, 13, 3), (777, 100, 10)):
        X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        S = torch.from_numpy(rng.uniform(0, 1, (n, P)).astype(np.float32))
        out = scaled_grams(X.to(cuda), S.to(cuda))
        assert out.shape == (P, d, d)
        assert _rel_err(out.cpu(), scaled_grams_plain(X, S)) <= 1e-5


def test_estimator_on_card_matches_cpu(cuda):
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(2000, 10, 4, seed=0)
    fits = {}
    for dev in ("cpu", "cuda"):
        before = scaled_grams.launches
        fits[dev] = BaggingClassifier(
            LogisticRegression(max_iter=2, hessian_impl="pallas"),
            n_estimators=12, oob_score=True, seed=0, device=dev,
        ).fit(X, y)
        launched = scaled_grams.launches - before
        assert (launched > 0) == (dev == "cuda")
    W = {k: v.ensemble_["W"].cpu() for k, v in fits.items()}
    assert _rel_err(W["cuda"], W["cpu"]) <= 1e-4
    np.testing.assert_allclose(fits["cuda"].predict_proba(X),
                               fits["cpu"].predict_proba(X), atol=1e-5)
    assert fits["cuda"].fit_report_["backend"] == "cuda"


def _hist_inputs(rng, n, F, B, N, K, R, *, shared, stats="onehot"):
    """Histogram operands with NaN rows, x equal to edges, rows outside
    the level and integer (or float) statistics."""
    X = rng.standard_normal((n, F) if shared else (R, n, F)).astype(np.float32)
    e = np.sort(rng.standard_normal((F, B - 1) if shared else (R, F, B - 1)),
                axis=-1)
    edges = np.concatenate([e, np.full(e.shape[:-1] + (1,), np.inf)],
                           axis=-1).astype(np.float32)
    Xv, Ev = X.reshape(-1, n, F), edges.reshape(-1, F, B)
    Xv[:, ::97] = np.nan
    Xv[:, ::31, 0] = Ev[:, 0, B // 2][:, None]
    node = rng.integers(0, N, (R, n)).astype(np.int32)
    node[:, ::53] = N + 3
    w = rng.poisson(1.0, (R, n)).astype(np.float32)
    if stats == "onehot":
        S = w[..., None] * np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    else:
        S = rng.standard_normal((R, n, K)).astype(np.float32) * w[..., None]
    return [torch.from_numpy(a) for a in (X, edges, node, S.astype(np.float32))]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (5000, 13, 16, 8, 5, 3),     # one tile, split rows
    (20000, 43, 32, 16, 7, 4),   # the headline level shape, feature tiles
    (3000, 5, 32, 300, 3, 2),    # node tiles
    (2000, 3, 256, 2, 100, 2),   # one (feature, node) slice a block
])
def test_hist_kernel_bitwise_equal_to_plain(cuda, shape, hist_dtype, shared):
    from spark_bagging_tpu_torch.ops.hist import (
        binned_left_stats,
        binned_left_stats_plain,
    )

    n, F, B, N, K, R = shape
    args = [t.to(cuda) for t in _hist_inputs(
        np.random.default_rng(n), n, F, B, N, K, R, shared=shared)]
    before = binned_left_stats.launches
    out = binned_left_stats(*args, n_nodes=N, hist_dtype=hist_dtype)
    again = binned_left_stats(*args, n_nodes=N, hist_dtype=hist_dtype)
    torch.cuda.synchronize()
    assert binned_left_stats.launches == before + 2
    assert out.shape == (R, F, B, N, K)
    # integer statistics: exact in any order, so equal bit for bit and
    # repeatable despite the shared-memory atomics
    assert torch.equal(out, again)
    assert torch.equal(out, binned_left_stats_plain(
        *args, n_nodes=N, hist_dtype=hist_dtype))


def test_hist_kernel_float_stats_within_tolerance(cuda):
    from spark_bagging_tpu_torch.ops.hist import (
        binned_left_stats,
        binned_left_stats_plain,
    )

    args = [t.to(cuda) for t in _hist_inputs(
        np.random.default_rng(9), 30000, 11, 32, 8, 3, 3, shared=True,
        stats="float")]
    for mode in ("float32", "bfloat16"):
        out = binned_left_stats(*args, n_nodes=8, hist_dtype=mode)
        want = binned_left_stats_plain(*args, n_nodes=8, hist_dtype=mode)
        scale = binned_left_stats_plain(*args[:3], args[3].abs(), n_nodes=8,
                                        hist_dtype=mode).clamp_min(1e-30)
        # the same float32 terms summed in another order
        assert float(((out - want).abs() / scale).max()) <= 1e-5


def test_tree_fit_on_card_matches_cpu(cuda):
    from spark_bagging_tpu_torch import BaggingClassifier, DecisionTreeClassifier
    from spark_bagging_tpu_torch.ops.hist import binned_left_stats
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(3000, 12, 4, seed=1)
    fits = {}
    for dev, impl in (("cpu", "fused"), ("cuda", "fused"), ("cuda", "dense")):
        before = binned_left_stats.launches
        fits[dev, impl] = BaggingClassifier(
            DecisionTreeClassifier(max_depth=4, n_bins=16, split_impl=impl),
            n_estimators=6, max_features=0.75, seed=0, device=dev,
        ).fit(X, y)
        launched = binned_left_stats.launches - before
        assert launched == (4 if (dev, impl) == ("cuda", "fused") else 0)
    # the kernel and the bf16 dense product give the same trees bit for
    # bit; against the CPU, leaf log-probabilities may differ by the
    # float32 log's last bit (CUDA's and the CPU's log differ)
    fused, dense = fits["cuda", "fused"].ensemble_, fits["cuda", "dense"].ensemble_
    ref = fits["cpu", "fused"].ensemble_
    for k in ("feature", "threshold", "gain", "leaf_logp"):
        assert torch.equal(fused[k], dense[k]), k
        if k != "leaf_logp":
            assert torch.equal(fused[k].cpu(), ref[k]), k
    np.testing.assert_array_max_ulp(fused["leaf_logp"].cpu().numpy(),
                                    ref["leaf_logp"].numpy(), maxulp=2)


def test_scaled_gram_kernel_depth_capped_row_splits(cuda):
    # enough replicas that occupancy alone would give each block more
    # rows than MAX_SPLIT_ROWS: the cap sets the row split
    from spark_bagging_tpu_torch.ops.gram import (
        MAX_SPLIT_ROWS,
        kernel_geometry,
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(2)
    R, n, d, P = 200, 3 * MAX_SPLIT_ROWS + 5, 23, 10
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = kernel_geometry(n, d, P, R, n_sm)
    assert g["rows_per_split"] <= MAX_SPLIT_ROWS and g["splits"] >= 4
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    S = torch.from_numpy(
        rng.uniform(-0.3, 1.0, (R, n, P)).astype(np.float32)).to(cuda)
    out = scaled_grams(X, S)
    assert torch.equal(out, scaled_grams(X, S))
    assert _rel_err(out, scaled_grams_plain(X, S)) <= 1e-5
