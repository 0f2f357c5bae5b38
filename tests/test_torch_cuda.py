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


# chip_smoke.GRAM_TOL: |kernel - reference| per entry over the entry's
# absolute-sum scale (the sound fp32 readings lie below 5.7e-6, a kernel
# that rounds to bf16 above 2.9e-5)
GRAM_TOL = 1.5e-5


def _entry_err(got, want, scale) -> float:
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


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


@pytest.mark.parametrize("B,K", [(9000, 7), (32, 2000)])
def test_hist_kernel_tiles_tables_beyond_one_block(cuda, B, K):
    # (B, K) slices beyond one block's shared memory: the wrapper splits
    # bins (and, where needed, classes) over launches of the same kernel
    from spark_bagging_tpu_torch.ops.hist import (
        binned_left_stats,
        binned_left_stats_plain,
        stat_tiles,
    )

    n, F, N, R = 4000, 3, 2, 2
    args = [t.to(cuda) for t in _hist_inputs(
        np.random.default_rng(B + K), n, F, B, N, K, R, shared=True)]
    before = binned_left_stats.launches
    out = binned_left_stats(*args, n_nodes=N, hist_dtype="bfloat16")
    torch.cuda.synchronize()
    assert binned_left_stats.launches - before == len(stat_tiles(B, K)) > 1
    assert torch.equal(out, binned_left_stats_plain(
        *args, n_nodes=N, hist_dtype="bfloat16"))


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


def _coded_inputs(rng, n, F_all, F, B, N, K, R, *, shared, stats="onehot"):
    """Bin codes of X with NaN rows, x on edges, a NaN edge suffix and
    duplicate edges; each replica's columns (a permutation's first F);
    nodes with rows outside the level; integer or float statistics."""
    from spark_bagging_tpu_torch.ops.hist import bin_codes_plain

    X, edges, node, S = _hist_inputs(rng, n, F_all, B, N, K, R, shared=True,
                                     stats=stats)
    edges[1, B // 2:B - 1] = np.nan       # a NaN edge suffix before +inf
    edges[2, 1:3] = edges[2, 1]           # duplicate edges
    codes = bin_codes_plain(X, edges)
    cols = torch.from_numpy(np.stack([
        rng.permutation(F_all)[:F] for _ in range(R)]).astype(np.int32))
    gathered = edges[cols.long()].contiguous()          # (R, F, B)
    if not shared:
        codes = torch.stack([codes] * R).contiguous()
    return codes, cols, gathered, node, S, X


@pytest.mark.parametrize("B", [32, 255, 300])
@pytest.mark.parametrize("shared", [True, False])
def test_bin_codes_kernel_bitwise_equal_to_plain(cuda, B, shared):
    from spark_bagging_tpu_torch.ops.hist import bin_codes, bin_codes_plain

    rng = np.random.default_rng(B)
    n, F, R = 7000, 9, 3
    X = rng.standard_normal((n, F) if shared else (R, n, F)).astype(np.float32)
    e = np.sort(rng.standard_normal((F, B - 1)), axis=-1).astype(np.float32)
    edges = np.concatenate([e, np.full((F, 1), np.inf, np.float32)], axis=1)
    edges[0, B // 3:B - 1] = np.nan        # NaN edge suffix
    edges[1, 2:6] = edges[1, 2]            # duplicate edges
    Xv = X.reshape(-1, n, F)
    Xv[:, ::13, 3] = np.nan
    Xv[:, ::7, 1] = edges[1, 2]            # x on a duplicated edge
    Xv[:, ::11, 2] = np.inf
    Xv[:, ::17, 4] = -np.inf
    edges_t = torch.from_numpy(edges)
    if not shared:  # per-replica edges too
        edges_t = torch.stack([edges_t] * R).contiguous()
    X_t = torch.from_numpy(X)
    before = bin_codes.launches
    got = bin_codes(X_t.to(cuda), edges_t.to(cuda))
    torch.cuda.synchronize()
    assert bin_codes.launches == before + 1
    want = bin_codes_plain(X_t, edges_t)
    assert got.dtype == (torch.uint8 if B <= 255 else torch.int16)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("integral", [False, True])
@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("shape", [
    (20000, 54, 43, 32, 16, 7, 4),  # the headline level shape
    (5000, 13, 9, 16, 1, 5, 3),     # one node, split rows
    (3000, 7, 5, 32, 300, 3, 2),    # node tiles
    (2000, 4, 3, 300, 2, 2, 2),     # int16 codes
])
def test_coded_hist_kernel_bitwise_equal_to_plain(cuda, shape, shared,
                                                  hist_dtype, integral):
    from spark_bagging_tpu_torch.ops.hist import (
        binned_left_stats,
        coded_left_stats,
        coded_left_stats_plain,
    )

    n, F_all, F, B, N, K, R = shape
    codes, cols, edges, node, S, _ = _coded_inputs(
        np.random.default_rng(n + F), n, F_all, F, B, N, K, R, shared=shared)
    args = [t.to(cuda) for t in (codes, edges, node, S)]
    kw = dict(n_nodes=N, hist_dtype=hist_dtype, cols=cols.to(cuda))
    before = binned_left_stats.launches
    out = coded_left_stats(*args, integral=integral, **kw)
    again = coded_left_stats(*args, integral=integral, **kw)
    torch.cuda.synchronize()
    assert binned_left_stats.launches == before + 2
    assert out.shape == (R, F, B, N, K)
    # integer statistics: exact in any order, so equal bit for bit and
    # repeatable despite the shared-memory atomics
    assert torch.equal(out, again)
    assert torch.equal(out, coded_left_stats_plain(*args, **kw))


def test_coded_hist_kernel_float_stats_within_tolerance(cuda):
    from spark_bagging_tpu_torch.ops.hist import (
        coded_left_stats,
        coded_left_stats_plain,
    )

    codes, cols, edges, node, S, _ = _coded_inputs(
        np.random.default_rng(10), 30000, 20, 11, 32, 8, 3, 3, shared=True,
        stats="float")
    args = [t.to(cuda) for t in (codes, edges, node, S)]
    for mode in ("float32", "bfloat16"):
        kw = dict(n_nodes=8, hist_dtype=mode, cols=cols.to(cuda))
        out = coded_left_stats(*args, **kw)
        want = coded_left_stats_plain(*args, **kw)
        scale = coded_left_stats_plain(*args[:3], args[3].abs(),
                                       **kw).clamp_min(1e-30)
        # the same float32 terms summed in another order
        assert float(((out - want).abs() / scale).max()) <= 1e-5


def test_coded_hist_kernel_tiles_bins_beyond_one_block(cuda):
    # 9,000 bins (int16 codes) through columns: bin slices of the codes
    # numbering, each its own launch, assemble the whole table
    from spark_bagging_tpu_torch.ops.hist import (
        binned_left_stats,
        coded_left_stats,
        coded_left_stats_plain,
        stat_tiles,
    )

    B, K, N = 9000, 7, 2
    codes, cols, edges, node, S, _ = _coded_inputs(
        np.random.default_rng(11), 4000, 6, 3, B, N, K, 2, shared=True)
    args = [t.to(cuda) for t in (codes, edges, node, S)]
    kw = dict(n_nodes=N, hist_dtype="bfloat16", cols=cols.to(cuda))
    before = binned_left_stats.launches
    out = coded_left_stats(*args, integral=True, **kw)
    torch.cuda.synchronize()
    assert binned_left_stats.launches - before == len(stat_tiles(B, K)) > 1
    assert torch.equal(out, coded_left_stats_plain(*args, **kw))


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


@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
def test_gram_mma_fragment_layout_matches_matmul(cuda, op_dtype):
    # one warp, one 16x8 tile, one k step through the kernel's fragment
    # loads and mma.sync (m16n8k8 TF32 as 3xTF32, or m16n8k16 bf16).
    # Small integers are exact in TF32 and bf16 and every sum of their
    # products is exact in fp32, so a misplaced fragment element shows
    from spark_bagging_tpu_torch.ops.gram import mma_tile_probe

    K = 16 if op_dtype == "bfloat16" else 8
    rng = np.random.default_rng(4)
    xa = torch.from_numpy(rng.integers(-8, 9, (K, 16)).astype(np.float32))
    xb = torch.from_numpy(rng.integers(-8, 9, (K, 8)).astype(np.float32))
    s = torch.from_numpy(rng.integers(1, 5, K).astype(np.float32))
    got = mma_tile_probe(xa.to(cuda), xb.to(cuda), s.to(cuda),
                         op_dtype=op_dtype)
    want = torch.matmul(xa.t().double(), (xb * s[:, None]).double())
    assert torch.equal(got.cpu().double(), want)


def test_gram_mma_3xtf32_tile_is_fp32_accurate(cuda):
    # on inexact operands one 3xTF32 tile stays within a few fp32 ulps
    # of the float64 sum of the fp32 products x * fp32(x' * s)
    from spark_bagging_tpu_torch.ops.gram import mma_tile_probe

    rng = np.random.default_rng(5)
    xa = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    xb = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(-1, 1, 8).astype(np.float32))
    got = mma_tile_probe(xa.to(cuda), xb.to(cuda), s.to(cuda),
                         op_dtype="float32").cpu().double()
    xs = (xb * s[:, None]).double()  # the fp32 product, rounded once
    want = xa.t().double() @ xs
    scale = xa.t().double().abs() @ xs.abs()
    assert _entry_err(got, want, scale) <= 2.0 ** -20


@pytest.mark.parametrize("shared_x", [True, False])
@pytest.mark.parametrize("op_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,P", [(250, 28), (913, 3)])
def test_scaled_gram_kernel_wide_d(cuda, d, P, op_dtype, shared_x):
    # the JAX kernel's widest d at these pair counts: output tiles above
    # the diagonal, ragged last tiles
    from spark_bagging_tpu_torch.ops.gram import (
        scaled_grams,
        scaled_grams_plain,
    )

    rng = np.random.default_rng(d)
    R, n = 2, 3000
    X = torch.from_numpy(rng.standard_normal(
        (n, d) if shared_x else (R, n, d)).astype(np.float32)).to(cuda)
    S = torch.from_numpy(
        rng.uniform(-0.3, 1.0, (R, n, P)).astype(np.float32)).to(cuda)
    out = scaled_grams(X, S, op_dtype=op_dtype)
    assert out.shape == (R, P, d, d)
    assert torch.equal(out, out.transpose(-1, -2))
    want = scaled_grams_plain(X, S, op_dtype=op_dtype)
    scale = scaled_grams_plain(X.abs(), S.abs())
    assert _entry_err(out, want, scale) <= GRAM_TOL


def test_scaled_gram_kernel_fp32_error_does_not_grow_with_depth(cuda):
    # 2**20 rows of mixed-sign S with the row split at its depth cap:
    # each block sums MAX_SPLIT_ROWS rows, so a biased accumulation
    # (truncating adds) would show as an error growing with the rows a
    # block sums; the reference is the float64 sum of the same fp32
    # products x_i * fp32(x_j * s)
    from spark_bagging_tpu_torch.ops.gram import (
        MAX_SPLIT_ROWS,
        kernel_geometry,
        scaled_grams,
    )

    rng = np.random.default_rng(6)
    R, n, d, P = 4, 2**20, 23, 10
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kernel_geometry(n, d, P, R, n_sm)["rows_per_split"] == MAX_SPLIT_ROWS
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    S = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (R, n, P)).astype(np.float32)).to(cuda)
    out = scaled_grams(X, S)
    X64 = X.double()
    for r in range(R):
        xs = (X[:, None, :] * S[r][:, :, None]).double()  # (n, P, d)
        want = torch.einsum("ni,npj->pij", X64, xs)
        scale = torch.einsum("ni,npj->pij", X64.abs(), xs.abs())
        want = want.triu() + want.triu(1).transpose(-1, -2)
        scale = scale.triu() + scale.triu(1).transpose(-1, -2)
        assert _entry_err(out[r].double(), want, scale) <= GRAM_TOL
        del xs
