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
        FIXED_BYTES,
        binned_left_stats,
        binned_left_stats_plain,
        stat_tiles,
    )

    n, F, B, N, K, R = shape
    args = [t.to(cuda) for t in _hist_inputs(
        np.random.default_rng(n), n, F, B, N, K, R, shared=shared)]
    before = binned_left_stats.launches
    out = binned_left_stats(*args, n_nodes=N, hist_dtype=hist_dtype)
    again = binned_left_stats(*args, n_nodes=N, hist_dtype=hist_dtype)
    torch.cuda.synchronize()
    # this entry point sums in fixed point, whose table is twice as wide:
    # a (B, K) slice may take more than one launch
    assert binned_left_stats.launches == before + 2 * len(
        stat_tiles(B, K, FIXED_BYTES))
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
        FIXED_BYTES,
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
    # the fixed-point accumulator's tiles (this entry point's statistics)
    assert binned_left_stats.launches - before == len(
        stat_tiles(B, K, FIXED_BYTES)) > 1
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


# tests/test_torch_hist.py FLOAT_TOL and chip_smoke.HIST_FLOAT_TOL: the
# kernel against its plain version on float statistics, per entry over
# the entry's absolute-sum scale (the same float32 terms in another order)
HIST_FLOAT_TOL = 1e-5


@pytest.mark.parametrize("hist_dtype", ["bfloat16", "float32"])
def test_regressor_fit_on_card_float_histogram_within_tolerance(
        cuda, hist_dtype, monkeypatch):
    # a forest regressor fitted on the card: every level runs the
    # histogram kernel's float accumulator (integral=False) on the
    # moments (w, w y, w y^2), each within the float tolerance of the
    # plain version on the level's own inputs
    from spark_bagging_tpu_torch import BaggingRegressor, DecisionTreeRegressor
    from spark_bagging_tpu_torch.models import tree as tree_mod
    from spark_bagging_tpu_torch.ops import hist as hist_ops
    from spark_bagging_tpu_torch.utils.datasets import make_regression

    X, y = make_regression(5000, 9, seed=2)
    levels = []
    coded = hist_ops.coded_left_stats

    def record(codes, edges, node, S, **kw):
        out = coded(codes, edges, node, S, **kw)
        levels.append((codes, edges, node.clone(), S, kw, out))
        return out

    monkeypatch.setattr(tree_mod.hist_ops, "coded_left_stats", record)
    before = hist_ops.binned_left_stats.launches
    before_float = hist_ops.binned_left_stats.float_launches
    reg = BaggingRegressor(
        DecisionTreeRegressor(max_depth=4, n_bins=16, split_impl="fused",
                              feature_subset="onethird",
                              hist_dtype=hist_dtype),
        n_estimators=6, max_features=0.8, seed=0, device=cuda,
    ).fit(X, y)
    torch.cuda.synchronize()
    assert hist_ops.binned_left_stats.launches - before == 4
    assert hist_ops.binned_left_stats.float_launches - before_float == 4
    assert [lv[4]["n_nodes"] for lv in levels] == [1, 2, 4, 8]
    for codes, edges, node, S, kw, out in levels:
        assert kw["integral"] is False and kw["hist_dtype"] == hist_dtype
        plain_kw = {k: v for k, v in kw.items() if k != "integral"}
        want = hist_ops.coded_left_stats_plain(codes, edges, node, S,
                                               **plain_kw)
        scale = hist_ops.coded_left_stats_plain(
            codes, edges, node, S.abs(), **plain_kw).clamp_min(1e-30)
        err = float(((out - want).abs() / scale).max())
        assert err <= HIST_FLOAT_TOL, err
    pred = reg.predict(X)
    assert pred.shape == (5000,) and np.isfinite(pred).all()
    assert reg.score(X, y) > 0.5


def test_regressors_on_card_match_cpu(cuda):
    # config 2's learner and a forest regressor: the same fits on the
    # card and on the CPU, within float32 tolerances
    from spark_bagging_tpu_torch import (
        BaggingRegressor,
        LinearRegression,
        RandomForestRegressor,
    )
    from spark_bagging_tpu_torch.utils.datasets import synthetic_california

    X, y = synthetic_california(4000)
    fits = {dev: BaggingRegressor(LinearRegression(l2=1e-4), n_estimators=10,
                                  oob_score=True, seed=0, device=dev).fit(X, y)
            for dev in ("cpu", "cuda")}
    np.testing.assert_array_equal(fits["cpu"].replica_weights(3),
                                  fits["cuda"].replica_weights(3))
    b_cpu = fits["cpu"].ensemble_["beta"]
    assert _rel_err(fits["cuda"].ensemble_["beta"].cpu(), b_cpu) <= 1e-5
    np.testing.assert_allclose(fits["cuda"].predict(X), fits["cpu"].predict(X),
                               atol=1e-4, rtol=0)
    fn, params, subs = fits["cuda"].aggregated_forward()
    np.testing.assert_allclose(
        fn(params, subs, torch.from_numpy(X).to(cuda)).cpu().numpy(),
        fits["cuda"].predict(X), atol=1e-4, rtol=0)
    assert abs(fits["cuda"].oob_score_ - fits["cpu"].oob_score_) <= 1e-5
    # integer-valued y in [-3, 3]: every moment is an integer below 256
    # (Poisson counts stay below 28), exact in bf16 operands, and every
    # sum exact in float32, so the kernel grows the CPU's trees
    yi = np.clip(np.round(y), -3, 3).astype(np.float32)
    forests = {dev: RandomForestRegressor(n_estimators=6, max_depth=4,
                                          n_bins=16, seed=0, device=dev
                                          ).fit(X, yi)
               for dev in ("cpu", "cuda")}
    for k in ("feature", "threshold", "gain"):
        assert torch.equal(forests["cuda"].ensemble_[k].cpu(),
                           forests["cpu"].ensemble_[k]), k
    np.testing.assert_allclose(forests["cuda"].predict(X),
                               forests["cpu"].predict(X), rtol=1e-6, atol=1e-6)


def _gbt_task(task):
    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        BaggingRegressor,
        GBTClassifier,
        GBTRegressor,
    )
    from spark_bagging_tpu_torch.utils.datasets import (
        make_classification,
        make_regression,
    )

    if task == "regression":
        return (*make_regression(2000, 8, seed=3), BaggingRegressor,
                GBTRegressor)
    X, y = make_classification(2000, 8, 2 if task == "binary" else 4,
                               seed=3, class_sep=0.8)
    return X, y, BaggingClassifier, GBTClassifier


@pytest.mark.parametrize("task", ["binary", "multiclass", "regression"])
def test_gbt_fit_on_card_matches_cpu(cuda, task):
    # the same bagged GBTs on the card (float32 operands, so the kernel
    # sums the CPU's terms) and on the CPU. Float sums in another order
    # may flip a tie between splits that part the weighted rows alike
    # (tests/test_torch_gbt.py), so: most split features equal, and each
    # replica's scores on the rows it trained on within 1e-5
    from spark_bagging_tpu_torch.ops.hist import binned_left_stats

    X, y, Est, Learner = _gbt_task(task)
    fits = {}
    for dev in ("cpu", "cuda"):
        before = binned_left_stats.float_launches
        fits[dev] = Est(Learner(n_rounds=4, max_depth=3, n_bins=16,
                                hist_dtype="float32", split_impl="fused"),
                        n_estimators=4, max_features=0.75, seed=0,
                        device=dev).fit(X, y)
        assert binned_left_stats.float_launches - before == \
            (12 if dev == "cuda" else 0)
    cpu, card = fits["cpu"], fits["cuda"]
    same = (card.ensemble_["feature"].cpu() == cpu.ensemble_["feature"])
    assert float(same.float().mean()) >= 0.9
    torch.testing.assert_close(card.ensemble_["f0"].cpu(), cpu.ensemble_["f0"],
                               rtol=1e-5, atol=1e-5)
    Xt = torch.from_numpy(X)
    fn, params, subs = card.replica_forward()
    got = fn(params, subs, Xt.to(cuda)).cpu().numpy()
    fn, params, subs = cpu.replica_forward()
    want = fn(params, subs, Xt).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    for r in range(4):
        inbag = cpu.replica_weights(r) > 0
        assert np.abs(got[r][inbag] - want[r][inbag]).max() <= 1e-5 * scale


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("hist_dtype", ["bfloat16", "float32"])
def test_gbt_levels_float_histogram_within_tolerance(cuda, task, hist_dtype,
                                                     monkeypatch):
    # every level of every round runs the float accumulator; each launch
    # within the float tolerance of the plain version on its own inputs.
    # Multiclass: one launch a level covers the replicas x classes trees
    from spark_bagging_tpu_torch.models import tree as tree_mod
    from spark_bagging_tpu_torch.ops import hist as hist_ops

    X, y, Est, Learner = _gbt_task(task)
    levels = []
    coded = hist_ops.coded_left_stats

    def record(codes, edges, node, S, **kw):
        out = coded(codes, edges, node, S, **kw)
        levels.append((codes, edges, node.clone(), S, kw, out))
        return out

    monkeypatch.setattr(tree_mod.hist_ops, "coded_left_stats", record)
    est = Est(Learner(n_rounds=3, max_depth=3, n_bins=16,
                      hist_dtype=hist_dtype, split_impl="fused"),
              n_estimators=5, max_features=0.75, seed=0, device=cuda
              ).fit(X, y)
    torch.cuda.synchronize()
    trees = 5 * (4 if task == "multiclass" else 1)
    assert [lv[4]["n_nodes"] for lv in levels] == [1, 2, 4] * 3
    for codes, edges, node, S, kw, out in levels:
        assert kw["integral"] is False and S.shape[0] == trees
        plain_kw = {k: v for k, v in kw.items() if k != "integral"}
        want = hist_ops.coded_left_stats_plain(codes, edges, node, S,
                                               **plain_kw)
        scale = hist_ops.coded_left_stats_plain(
            codes, edges, node, S.abs(), **plain_kw).clamp_min(1e-30)
        err = float(((out - want).abs() / scale).max())
        assert err <= HIST_FLOAT_TOL, err
    proba = est.predict_proba(X)
    assert np.isfinite(proba).all() and est.score(X, y) > 0.6


def test_float_accumulator_stays_accurate_over_many_rows(cuda):
    # round 0 of BASELINE config 7's GBTs (32 replicas, 800,000 x 28): the
    # Newton weights repeat (Poisson counts x one value a replica), where
    # a float32 running sum of like terms strayed with the rows a block
    # added into one bin (88,889 rows a block: 1.9e-5). The fixed-point
    # accumulator sums integers exactly: every entry stays within the
    # float tolerance of a float64 sum of the same terms
    from spark_bagging_tpu_torch import GBTClassifier
    from spark_bagging_tpu_torch.ops import hist as hist_ops
    from spark_bagging_tpu_torch.ops import prng
    from spark_bagging_tpu_torch.ops.bootstrap import bootstrap_weights
    from spark_bagging_tpu_torch.utils import datasets

    X, y = datasets.synthetic_higgs(1_000_000)
    X, y, _, _ = datasets.train_test_split(datasets.standardize(X), y)
    Xd = torch.from_numpy(X).to(cuda)
    yd = torch.from_numpy(y).to(cuda).float()
    R, (n, F), B = 32, X.shape, 32
    gbt = GBTClassifier(n_rounds=1, max_depth=4, n_bins=B)
    prep = gbt.prepare(Xd)
    w = bootstrap_weights(prng.key(0, cuda), torch.arange(R, device=cuda), n)
    f0 = gbt._init_margin(yd, w, w.sum(-1))
    h, z = gbt._pseudo(yd, f0[:, None].expand(R, n), w)
    S = torch.stack([h, h * z, h * z * z], -1).contiguous()
    node = torch.zeros((R, n), dtype=torch.int32, device=cuda)
    out = hist_ops.coded_left_stats(prep["codes"], prep["edges"], node, S,
                                    n_nodes=1, hist_dtype="float32")
    bins = torch.arange(B, device=cuda)
    T = (prep["codes"][:, :, None] <= bins).reshape(n, F * B).double()
    St = S.double().permute(1, 0, 2).reshape(n, R * 3)
    want = (T.t() @ St).reshape(F, B, R, 3).permute(2, 0, 1, 3)
    scale = (T.t() @ St.abs()).reshape(F, B, R, 3).permute(2, 0, 1, 3)
    err = ((out[:, :, :, 0].double() - want).abs()
           / scale.clamp_min(1e-30)).max()
    assert float(err) <= HIST_FLOAT_TOL, float(err)


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


@pytest.mark.parametrize("integral", [True, False])
def test_chunk_level_hist_kernel_matches_plain_with_a_padded_tail(
        cuda, integral):
    # a stream's tail chunk: rows past n_valid are zero-padded and weigh
    # nothing; the kernel route (bin codes of the chunk, then the
    # histogram through each replica's columns) against the plain one
    from spark_bagging_tpu_torch import DecisionTreeClassifier
    from spark_bagging_tpu_torch.ops.hist import (
        bin_codes,
        binned_left_stats,
    )

    rng = np.random.default_rng(8)
    n, n_valid, F_all, F, B, N, K, R = 4096, 1500, 20, 15, 32, 4, 3, 5
    X = rng.standard_normal((n, F_all)).astype(np.float32)
    X[n_valid:] = 0.0
    X[:7, 2] = np.nan
    edges = np.sort(rng.standard_normal((F_all, B)).astype(np.float32), 1)
    edges[:, -1] = np.inf
    cols = np.stack([rng.permutation(F_all)[:F] for _ in range(R)])
    node = rng.integers(0, N, (R, n)).astype(np.int32)
    S = (rng.integers(0, 4, (R, n, K)) if integral
         else rng.standard_normal((R, n, K))).astype(np.float32)
    S[:, n_valid:] = 0.0
    tree = DecisionTreeClassifier(n_bins=B, split_impl="fused",
                                  hist_dtype="float32")
    args = [torch.from_numpy(a) for a in (X, S, edges, node)]
    want = tree._chunk_level_hist(*args, N, cols=torch.from_numpy(cols))
    before = (binned_left_stats.launches, bin_codes.launches)
    got = tree._chunk_level_hist(*[a.to(cuda) for a in args], N,
                                 cols=torch.from_numpy(cols).to(cuda),
                                 integral=integral)
    torch.cuda.synchronize()
    assert (binned_left_stats.launches, bin_codes.launches) == (
        before[0] + 1, before[1] + 1)
    if integral:
        assert torch.equal(got.cpu(), want)
    else:
        scale = tree._chunk_level_hist(
            args[0], args[1].abs(), *args[2:], N,
            cols=torch.from_numpy(cols)).clamp_min(1e-30)
        assert float(((got.cpu() - want).abs() / scale).max()) \
            <= HIST_FLOAT_TOL


def test_streamed_tree_fit_on_card_matches_cpu(cuda):
    from spark_bagging_tpu_torch import BaggingClassifier, DecisionTreeClassifier
    from spark_bagging_tpu_torch.ops.hist import bin_codes, binned_left_stats
    from spark_bagging_tpu_torch.utils.datasets import make_classification
    from spark_bagging_tpu_torch.utils.io import ArrayChunks

    X, y = make_classification(3000, 12, 4, seed=1)
    fits = {}
    for dev in ("cpu", "cuda"):
        before = (binned_left_stats.launches, bin_codes.launches)
        fits[dev] = BaggingClassifier(
            DecisionTreeClassifier(max_depth=4, n_bins=16),
            n_estimators=6, max_features=0.75, seed=0, device=dev,
        ).fit_stream(ArrayChunks(X, y, 1024))
        launched = (binned_left_stats.launches - before[0],
                    bin_codes.launches - before[1])
        # one of each a chunk a level: 3 chunks x 4 levels
        assert launched == ((12, 12) if dev == "cuda" else (0, 0))
    card, ref = fits["cuda"].ensemble_, fits["cpu"].ensemble_
    for k in ("feature", "threshold", "gain"):
        assert torch.equal(card[k].cpu(), ref[k]), k
    np.testing.assert_array_max_ulp(card["leaf_logp"].cpu().numpy(),
                                    ref["leaf_logp"].numpy(), maxulp=2)


def test_streamed_mlp_fit_on_card_matches_cpu(cuda):
    # tests/test_torch_stream.py's tolerances at this stream, which hold
    # the CPU to JAX: parameters LONG_PARAM_TOL (Adam's normalized steps
    # move a near-zero gradient element by up to lr on a last-bit
    # difference), probabilities MLP_TOL
    from spark_bagging_tpu_torch import BaggingClassifier, MLPClassifier
    from spark_bagging_tpu_torch.utils.datasets import synthetic_higgs
    from spark_bagging_tpu_torch.utils.io import SyntheticChunks

    fits = {
        dev: BaggingClassifier(MLPClassifier(hidden=32, lr=0.01),
                               n_estimators=16, seed=0, device=dev)
        .fit_stream(SyntheticChunks(synthetic_higgs, 40_000, 5_000, seed=11),
                    classes=[0, 1], n_epochs=2, steps_per_chunk=2, lr=0.01)
        for dev in ("cpu", "cuda")
    }
    for k, v in fits["cuda"].ensemble_.items():
        np.testing.assert_allclose(v.cpu().numpy(),
                                   fits["cpu"].ensemble_[k].numpy(),
                                   atol=2e-4, rtol=0, err_msg=k)
    X, _ = synthetic_higgs(5000, seed=3, structure_seed=11)
    np.testing.assert_allclose(fits["cuda"].predict_proba(X),
                               fits["cpu"].predict_proba(X), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (20000, 54, 43, 32, 16, 3, 4),  # the headline level's width
    (40000, 13, 9, 16, 1, 3, 3),    # one node, split rows
    (3000, 7, 5, 32, 300, 3, 2),    # node tiles
    (2000, 4, 3, 300, 2, 2, 2),     # int16 codes
    (1000, 3, 3, 32, 2, 1000, 2),   # classes tiled over launches
])
def test_float_accumulator_bitwise_repeatable_and_equal_to_fixed_plain(
        cuda, shape, hist_dtype):
    # float statistics sum in fixed point: integers, exact in any order,
    # so the table repeats bit for bit and equals its plain version
    from spark_bagging_tpu_torch.ops.hist import (
        coded_left_stats,
        coded_left_stats_fixed,
    )

    n, F_all, F, B, N, K, R = shape
    codes, cols, edges, node, S, _ = _coded_inputs(
        np.random.default_rng(n + K), n, F_all, F, B, N, K, R, shared=True,
        stats="float")
    args = [t.to(cuda) for t in (codes, edges, node, S)]
    kw = dict(n_nodes=N, hist_dtype=hist_dtype, cols=cols.to(cuda))
    outs = [coded_left_stats(*args, **kw) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], coded_left_stats_fixed(*args, **kw))
    # the same plain version on the CPU: the same bits
    cpu = coded_left_stats_fixed(codes, edges, node, S, n_nodes=N,
                                 hist_dtype=hist_dtype, cols=cols)
    assert torch.equal(outs[0].cpu(), cpu)


def test_fixed_scales_equal_on_card_and_cpu(cuda):
    from spark_bagging_tpu_torch.ops.hist import fixed_scales

    S = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 777, 3)).astype(np.float32)) * torch.tensor(
        [1e-30, 1e-3, 1.0, 7.0, 1e30])[:, None, None]
    for a, b in zip(fixed_scales(S.to(cuda)), fixed_scales(S)):
        assert torch.equal(a.cpu(), b)


def _zoo_cases():
    from spark_bagging_tpu_torch import (
        AFTSurvivalRegression,
        BernoulliNB,
        FMClassifier,
        FMRegressor,
        GaussianNB,
        GeneralizedLinearRegression,
        IsotonicRegression,
        LinearSVC,
        LogisticRegression,
        MultinomialNB,
    )

    # (learner, task, the CPU parity tolerances: parameters, predictions)
    return {
        "svc": (lambda: LinearSVC(), "clf", 5e-3, 1e-4),
        "gaussian_nb": (GaussianNB, "clf", 1e-5, 1e-5),
        "bernoulli_nb": (BernoulliNB, "clf", 1e-5, 1e-5),
        "multinomial_nb": (MultinomialNB, "clf", 1e-5, 1e-5),
        "fm_classifier": (lambda: FMClassifier(factor_size=4, max_iter=50),
                          "clf", 1e-5, 1e-5),
        "logistic_adam": (lambda: LogisticRegression(solver="adam",
                                                     max_iter=60, lr=0.05),
                          "clf", 1e-5, 1e-5),
        "glm_gamma": (lambda: GeneralizedLinearRegression(family="gamma"),
                      "pos", 5e-4, 5e-4),
        "glm_binomial": (lambda: GeneralizedLinearRegression(
            family="binomial"), "bin", 5e-4, 5e-4),
        "fm_regressor": (lambda: FMRegressor(factor_size=4, max_iter=50),
                         "reg", 1e-5, 1e-5),
        "isotonic": (lambda: IsotonicRegression(n_bins=32), "reg", 1e-5, 1e-5),
        "aft": (lambda: AFTSurvivalRegression(max_iter=100), "aft", 2e-4,
                2e-4),
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", ["svc", "gaussian_nb", "bernoulli_nb",
                                  "multinomial_nb", "fm_classifier",
                                  "logistic_adam", "glm_gamma",
                                  "glm_binomial", "fm_regressor", "isotonic",
                                  "aft"])
def test_zoo_fit_on_card_matches_cpu(cuda, name):
    # the learner zoo on the card against the CPU port, within the CPU
    # parity tests' tolerances (tests/test_torch_zoo_clf.py, _reg.py)
    from spark_bagging_tpu_torch import BaggingClassifier, BaggingRegressor
    from spark_bagging_tpu_torch.utils.datasets import (
        make_classification,
        make_regression,
    )

    learner, task, p_tol, y_tol = _zoo_cases()[name]
    fit_kw = {}
    if task == "clf":
        X, y = make_classification(2000, 8, 3, seed=4)
        if name == "multinomial_nb":
            X = np.abs(X)
        Est = BaggingClassifier
    else:
        X, y = make_regression(2000, 6, seed=4)
        Est = BaggingRegressor
        if task == "pos":
            y = ((y - y.min() + 0.5) / (y - y.min() + 0.5).mean()).astype(
                np.float32)
        elif task == "bin":
            y = (y > np.median(y)).astype(np.float32)
        elif task == "aft":
            # noisy times: noise-free ones drive sigma to 0
            noise = np.random.default_rng(4).standard_normal(2000)
            y = np.exp(0.3 * X[:, 0] + 0.1 * noise).astype(np.float32)
            fit_kw = {"aux": (np.arange(2000) % 5 != 0).astype(np.float32)}
    fits = {dev: Est(learner(), n_estimators=6, max_features=0.75, seed=0,
                     device=dev).fit(X, y, **fit_kw)
            for dev in ("cpu", "cuda")}
    cpu, card = fits["cpu"], fits["cuda"]
    assert torch.equal(card.subspaces_.cpu(), cpu.subspaces_)
    for k, v in card.ensemble_.items():
        assert _rel(v.cpu().numpy(), cpu.ensemble_[k].numpy()) <= p_tol, k
    if task == "clf":
        assert _rel(card.predict_proba(X), cpu.predict_proba(X)) <= y_tol
    else:
        assert _rel(card.predict(X), cpu.predict(X)) <= y_tol
    if task == "aft":
        assert _rel(card.predict_quantiles(X), cpu.predict_quantiles(X)) \
            <= y_tol


def test_aft_stream_with_aux_col_on_card_matches_cpu(cuda):
    from spark_bagging_tpu_torch import AFTSurvivalRegression, BaggingRegressor
    from spark_bagging_tpu_torch.utils.datasets import make_regression
    from spark_bagging_tpu_torch.utils.io import ArrayChunks

    X, _ = make_regression(3000, 6, seed=5)
    noise = np.random.default_rng(5).standard_normal(3000)
    t = np.exp(0.3 * X[:, 0] + 0.1 * noise).astype(np.float32)
    cens = (np.arange(3000) % 5 != 0).astype(np.float32)
    Xa = np.concatenate([X, cens[:, None]], axis=1)
    fits = {dev: BaggingRegressor(AFTSurvivalRegression(), n_estimators=4,
                                  seed=0, device=dev).fit_stream(
        ArrayChunks(Xa, t, 512), n_epochs=3, steps_per_chunk=2, lr=0.05,
        aux_col=-1, prefetch=0) for dev in ("cpu", "cuda")}
    for k, v in fits["cuda"].ensemble_.items():
        assert _rel(v.cpu().numpy(), fits["cpu"].ensemble_[k].numpy()) <= 2e-4
    assert _rel(fits["cuda"].predict(X), fits["cpu"].predict(X)) <= 2e-4


# -- the serving plane: one CUDA graph a bucket --------------------------

def _serving_cases():
    from spark_bagging_tpu_torch import (
        AFTSurvivalRegression,
        BernoulliNB,
        DecisionTreeClassifier,
        DecisionTreeRegressor,
        FMClassifier,
        GaussianNB,
        GBTClassifier,
        GBTRegressor,
        GeneralizedLinearRegression,
        IsotonicRegression,
        LinearRegression,
        LinearSVC,
        LogisticRegression,
        MLPClassifier,
        MultinomialNB,
    )

    # (learner, task, estimator options): every learner family's
    # aggregated forward, each captured at every bucket of a small ladder
    return {
        "logistic": (lambda: LogisticRegression(max_iter=3), "clf", {}),
        "logistic_chunked": (lambda: LogisticRegression(max_iter=3), "clf",
                             {"chunk_size": 3, "max_features": 0.75}),
        "tree_hard": (lambda: DecisionTreeClassifier(max_depth=4), "clf",
                      {"voting": "hard", "max_features": 0.75}),
        "gbt_binary": (lambda: GBTClassifier(n_rounds=3, max_depth=3),
                       "bin_clf", {}),
        "gbt_multiclass": (lambda: GBTClassifier(n_rounds=3, max_depth=3),
                           "clf", {}),
        "svc": (LinearSVC, "clf", {}),
        "gaussian_nb": (GaussianNB, "clf", {}),
        "bernoulli_nb": (BernoulliNB, "clf", {}),
        "multinomial_nb": (MultinomialNB, "abs_clf", {}),
        "fm": (lambda: FMClassifier(factor_size=4, max_iter=10), "clf", {}),
        "mlp": (lambda: MLPClassifier(hidden=8, max_iter=5), "clf", {}),
        "ridge": (LinearRegression, "reg", {}),
        "tree_reg": (lambda: DecisionTreeRegressor(max_depth=4), "reg",
                     {"max_features": 0.75}),
        "gbt_reg": (lambda: GBTRegressor(n_rounds=3, max_depth=3), "reg",
                    {}),
        "glm": (lambda: GeneralizedLinearRegression(family="gaussian"),
                "reg", {}),
        "isotonic": (lambda: IsotonicRegression(n_bins=32), "iso", {}),
        "aft": (lambda: AFTSurvivalRegression(max_iter=20), "aft", {}),
    }


def _serving_model(name, device="cuda", seed=0):
    from spark_bagging_tpu_torch import BaggingClassifier, BaggingRegressor
    from spark_bagging_tpu_torch.utils.datasets import (
        make_classification,
        make_regression,
    )

    learner, task, opts = _serving_cases()[name]
    fit_kw = {}
    if task in ("clf", "bin_clf", "abs_clf"):
        X, y = make_classification(1500, 10, 2 if task == "bin_clf" else 3,
                                   seed=3)
        if task == "abs_clf":
            X = np.abs(X)
        Est = BaggingClassifier
    else:
        X, y = make_regression(1500, 1 if task == "iso" else 6, seed=3)
        Est = BaggingRegressor
        if task == "aft":
            y = np.exp(0.3 * X[:, 0]).astype(np.float32)
            fit_kw = {"aux": (np.arange(1500) % 5 != 0).astype(np.float32)}
    est = Est(learner(), n_estimators=6, seed=seed, device=device,
              **opts).fit(X, y, **fit_kw)
    return est, X


@pytest.mark.parametrize("name", sorted(_serving_cases()))
def test_serving_graph_replay_equals_eager_every_bucket(cuda, name):
    # every bucket's captured graph gives bit for bit what the same
    # closure gives run eagerly at that bucket, and the served output
    # stays within float32 rounding of the unpadded predict
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    est, X = _serving_model(name)
    ex = EnsembleExecutor(est, min_bucket_rows=1, max_batch_rows=64)
    assert ex.warmup() == (1, 2, 4, 8, 16, 32, 64)
    fn, params, subs = est.aggregated_forward()
    for b in ex.compiled_buckets:
        Xb = np.ascontiguousarray(X[:b], np.float32)
        eager = fn(params, subs, torch.from_numpy(Xb).to(cuda)).cpu().numpy()
        np.testing.assert_array_equal(ex.program(b).run(Xb, b), eager)
    want = (est.predict_proba(X[:300]) if est.task == "classification"
            else est.predict(X[:300]))
    np.testing.assert_allclose(ex.forward(X[:300]), want, rtol=1e-5,
                               atol=1e-6)


def test_serving_zero_captures_after_warmup(cuda):
    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import ModelRegistry

    est, X = _serving_model("logistic")
    reg = ModelRegistry()
    ex = reg.register("m", est, warmup=True, min_bucket_rows=1,
                      max_batch_rows=256)
    assert ex.compiled_buckets == (1, 2, 4, 8, 16, 32, 64, 128, 256)
    assert ex.graph_pool_bytes > 0
    c0 = telemetry.registry().counter("sbt_serving_compiles_total").value
    rng = np.random.default_rng(0)
    with reg.batcher("m", max_delay_ms=0.5, max_batch_rows=256) as b:
        futs = [b.submit(X[i:i + n]) for i, n in
                zip(rng.integers(0, 1000, 60), rng.integers(1, 300, 60))]
        for f in futs:
            f.result(30)
    assert telemetry.registry().counter(
        "sbt_serving_compiles_total").value == c0


def test_serving_two_threads_replay_one_bucket_get_their_own_rows(cuda):
    import threading

    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    est, X = _serving_model("logistic")
    ex = EnsembleExecutor(est, min_bucket_rows=8, max_batch_rows=8)
    ex.warmup()
    want = [ex.forward(X[8 * t:8 * t + 8]) for t in range(2)]
    errors = []

    def hammer(t):
        try:
            for _ in range(300):
                got = ex.forward(X[8 * t:8 * t + 8])
                if not np.array_equal(got, want[t]):
                    errors.append(t)
                    return
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors and not any(th.is_alive() for th in threads)


def test_serving_swap_frees_the_old_pool(cuda):
    # trees: no cuBLAS, so the card's reserved bytes are the graphs' and
    # the buffers' alone (cuBLAS keeps a workspace per stream)
    import gc
    import weakref

    from spark_bagging_tpu_torch.serving import ModelRegistry

    old, X = _serving_model("tree_hard", seed=0)
    new, _ = _serving_model("tree_hard", seed=1)
    reg = ModelRegistry(min_bucket_rows=1, max_batch_rows=1024)
    ex = reg.register("m", old, warmup=True)
    pool = ex.graph_pool_bytes
    assert pool > 0
    graphs = [weakref.ref(ex.program(b).graph) for b in ex.compiled_buckets]
    del old, ex
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reg.swap("m", new)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the old executor's graphs are gone, and their pool with them: the
    # card holds the new executor's captures in place of the old ones
    assert all(g() is None for g in graphs)
    after = torch.cuda.memory_reserved()
    assert after <= before + 0.25 * pool
    np.testing.assert_array_equal(reg.executor("m").forward(X[:5]),
                                  new.predict_proba(X[:5]))


@pytest.mark.parametrize("name", sorted(_serving_cases()))
def test_graph_audit_of_every_cuda_executor(cuda, name):
    # analysis.audit_executor on the card: every learner family's
    # serving forward traced with make_fx at both ends of a ladder, no
    # host sync, no float64 (the MLP's CPU-only float64 first layer is
    # not on this path), bounded constants, no kernel launched, and one
    # real call under torch.cuda.set_sync_debug_mode("error")
    from spark_bagging_tpu_torch.analysis import audit_executor
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    est, _ = _serving_model(name)
    ex = EnsembleExecutor(est, min_bucket_rows=1, max_batch_rows=64)
    for rows in (1, 64):
        report = audit_executor(ex, n_rows=rows)
        assert report.ok and report.n_eqns > 0
        assert report.sync_debug_checked
        assert not report.wide_dtypes and not report.host_syncs
        assert report.opaque_kernels == {}
    assert torch.cuda.get_sync_debug_mode() == 0


def test_graph_audit_flags_a_planted_item_under_sync_debug(cuda):
    from spark_bagging_tpu_torch.analysis import AuditError, audit_fn

    def planted(x):
        return x * x.sum().item()

    report = audit_fn(planted, torch.ones(8, device=cuda), name="planted")
    assert report.sync_debug_checked
    assert any("_local_scalar_dense" in p for p in report.problems)
    assert any("set_sync_debug_mode" in p for p in report.problems)
    assert torch.cuda.get_sync_debug_mode() == 0
    with pytest.raises(AuditError):
        report.raise_if_bad()
    clean = audit_fn(lambda x: x * x.sum(), torch.ones(8, device=cuda))
    assert clean.ok and clean.sync_debug_checked


def _churn_the_allocator(nbytes: int) -> None:
    # take the freed blocks back and fill them with NaN, so a graph that
    # replays against freed memory reads garbage
    junk = [torch.full((nbytes // 4 // 8,), float("nan"), device="cuda")
            for _ in range(8)]
    torch.cuda.synchronize()
    del junk


def test_serving_adopted_graphs_outlive_the_model_they_read(cuda, tmp_path):
    # a checkpoint loaded under a second name adopts the first name's
    # captured graphs (the cache is not cleared); the first name is then
    # swapped to another model and everything of the first model is
    # dropped and freed. The adopted graphs hold the tensors they read,
    # so the second name serves the same bits
    import gc

    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import ModelRegistry

    first, X = _serving_model("logistic", seed=0)
    other, _ = _serving_model("logistic", seed=1)
    reg = ModelRegistry(min_bucket_rows=1, max_batch_rows=64)
    reg.register("a", first, warmup=True)
    reg.save("a", str(tmp_path / "a"))
    c0 = telemetry.registry().counter("sbt_serving_compiles_total").value
    ex_b = reg.load("b", str(tmp_path / "a"))
    assert telemetry.registry().counter(
        "sbt_serving_compiles_total").value == c0
    assert ex_b.program(64) is reg.executor("a").program(64)
    sizes = (1, 3, 17, 64, 100)
    want = [ex_b.forward(X[:n]) for n in sizes]
    ref = ex_b.model.predict_proba(X[:100])
    reg.swap("a", other)
    del first
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _churn_the_allocator(256 << 20)
    for n, w in zip(sizes, want):
        np.testing.assert_array_equal(ex_b.forward(X[:n]), w)
    np.testing.assert_allclose(ex_b.forward(X[:100]), ref, rtol=1e-5,
                               atol=1e-6)


def test_serving_graph_pool_bytes_are_the_pools_segments(cuda):
    from spark_bagging_tpu_torch.serving import EnsembleExecutor
    from spark_bagging_tpu_torch.serving.executor import pool_reserved_bytes

    est, _ = _serving_model("tree_hard")
    ex = EnsembleExecutor(est, min_bucket_rows=1, max_batch_rows=256)
    ex.warmup()
    progs = [ex.program(b) for b in ex.compiled_buckets]
    static = sum(p.x.nbytes + p.out.nbytes for p in progs)
    assert all(p.nbytes >= p.x.nbytes + p.out.nbytes for p in progs)
    assert ex.graph_pool_bytes == pool_reserved_bytes(ex._pool) + static
    assert 0 < ex.graph_pool_bytes <= torch.cuda.memory_reserved()


def test_serving_failed_swap_releases_its_captures(cuda):
    import gc
    import weakref

    from spark_bagging_tpu_torch import faults
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache

    old, _ = _serving_model("tree_hard", seed=0)
    new, _ = _serving_model("tree_hard", seed=1)
    reg = ModelRegistry(min_bucket_rows=1, max_batch_rows=64)
    reg.register("m", old, warmup=True)
    made = []
    put = program_cache.ProgramCache.put

    def spy(self, key, prog):
        made.append(weakref.ref(prog))
        return put(self, key, prog)

    plan = faults.FaultPlan([{"site": "registry.swap.precompile",
                              "action": "error", "at": [4]}])
    program_cache.ProgramCache.put = spy
    try:
        with faults.armed(plan), pytest.raises(RuntimeError,
                                               match="rolled") as info:
            reg.swap("m", new)
    finally:
        program_cache.ProgramCache.put = put
    gc.collect()
    # freed even while the error (whose traceback holds the replacement
    # executor) is kept
    assert info.value is not None
    assert len(made) == 3 and all(r() is None for r in made)


def test_serving_failed_capture_raises_instead_of_serving_eagerly(cuda):
    # last in the file: a capture that syncs with the host invalidates
    # the capture; the executor must raise, never fall back to eager
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    est, X = _serving_model("logistic")
    fn, params, subs = est.aggregated_forward()

    def syncing(p, s, x):
        out = fn(p, s, x)
        if float(out.sum().item()) < -1.0:  # host sync inside the forward
            out = out * 2
        return out

    class Syncing:
        task, n_features_in_, classes_ = est.task, est.n_features_in_, \
            est.classes_

        def aggregated_forward(self):
            return syncing, params, subs

    ex = EnsembleExecutor(Syncing(), min_bucket_rows=4, max_batch_rows=4)
    with pytest.raises(RuntimeError, match="never served eagerly"):
        ex.forward(X[:3])
    assert ex.compiled_buckets == ()


# -- growth and resume on the card ------------------------------------

@pytest.mark.parametrize("kind", ["logistic", "gini_tree"])
def test_warm_growth_on_card_equals_the_cold_fit(cuda, kind):
    """4 -> 8 replicas grown on the card: bootstrap weights and
    subspaces bitwise the cold fit's, Gini trees bitwise (integral
    statistics in int32). The Gram kernel splits its rows by the
    replicas a launch holds (4 here against the cold fit's 8, at 3,000
    rows), so the logistic Hessians sum in another order: its weights
    are held to chip_smoke's W_REL_TOL (1e-3 of the largest) and its
    probabilities to 1e-4 (2.7e-5 found on an H100 after two Newton
    steps), not bitwise."""
    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        DecisionTreeClassifier,
        LogisticRegression,
    )
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.ops.hist import bin_codes
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(3000, 12, 4, seed=1)
    learner = (LogisticRegression(max_iter=2, hessian_impl="pallas")
               if kind == "logistic" else
               DecisionTreeClassifier(max_depth=4, n_bins=16,
                                      split_impl="fused"))
    kw = dict(max_features=0.75, seed=0, device="cuda", oob_score=True)
    cold = BaggingClassifier(learner, n_estimators=8, **kw).fit(X, y)
    warm = BaggingClassifier(learner, n_estimators=4, warm_start=True,
                             **kw).fit(X, y)
    before = (scaled_grams.launches, bin_codes.launches)
    warm.set_params(n_estimators=8).fit(X, y)
    grams, codes = (scaled_grams.launches - before[0],
                    bin_codes.launches - before[1])
    assert (grams > 0) if kind == "logistic" else (codes == 1)
    assert torch.equal(warm.subspaces_, cold.subspaces_)
    for i in (0, 5):
        np.testing.assert_array_equal(warm.replica_weights(i),
                                      cold.replica_weights(i))
    if kind == "gini_tree":
        for k in cold.ensemble_:
            assert torch.equal(warm.ensemble_[k], cold.ensemble_[k]), k
        tol = 0.0
    else:
        assert _rel_err(warm.ensemble_["W"], cold.ensemble_["W"]) <= 1e-3
        tol = 1e-4
    np.testing.assert_allclose(warm.predict_proba(X), cold.predict_proba(X),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["mlp", "tree"])
def test_resumed_stream_on_card_equals_the_uninterrupted_fit(cuda, tmp_path,
                                                             kind):
    """A stream killed mid-fit on the card and resumed from its snapshot
    equals the uninterrupted card fit bit for bit: the same shapes and
    the same launches; the resumed tree stream launches the histogram
    only for the levels it has left."""
    from spark_bagging_tpu_torch import (
        BaggingClassifier,
        DecisionTreeClassifier,
        MLPClassifier,
    )
    from spark_bagging_tpu_torch.ops.hist import binned_left_stats
    from spark_bagging_tpu_torch.utils.datasets import make_classification
    from spark_bagging_tpu_torch.utils.io import ArrayChunks

    class Killed(Exception):
        pass

    class Dying(ArrayChunks):
        yielded, after = 0, None

        def chunks_from(self, start):
            for chunk in super().chunks_from(start):
                if self.after is not None and self.yielded >= self.after:
                    raise Killed()
                self.yielded += 1
                yield chunk

    X, y = make_classification(3000, 12, 4, seed=1)
    if kind == "mlp":
        learner, fit = MLPClassifier(hidden=8), dict(
            n_epochs=2, steps_per_chunk=2, lr=0.01)
    else:
        learner, fit = DecisionTreeClassifier(max_depth=4, n_bins=16), {}

    def run(src, **kw):
        return BaggingClassifier(learner, n_estimators=6, max_features=0.75,
                                 seed=0, device="cuda").fit_stream(
            src, classes=[0, 1, 2, 3], prefetch=0, **fit, **kw)

    full = run(ArrayChunks(X, y, 512))
    ckpt = str(tmp_path / "ckpt")
    dying = Dying(X, y, 512)
    dying.after = 8 if kind == "mlp" else 20  # tree: level pass 2
    with pytest.raises(Killed):
        run(dying, checkpoint_dir=ckpt, checkpoint_every=3)
    before = binned_left_stats.launches
    resumed = run(ArrayChunks(X, y, 512), resume_from=ckpt)
    if kind == "tree":
        # 6 chunks a pass; levels 0 and 1 were done: 2 levels left
        assert binned_left_stats.launches - before == 2 * 6
    for k in full.ensemble_:
        assert torch.equal(resumed.ensemble_[k], full.ensemble_[k]), k


# -- online updates and the file readers on the card --------------------

def test_online_step_on_card_matches_cpu(cuda):
    """One warm ``partial_fit`` step on the card and on the CPU from the
    same state (the CPU twin of the card's fit carries the card's
    params): the Newton step's Hessians go through the scaled-Gram
    kernel on the card, so the params are held within the CPU parity
    tests' logistic tolerance (max |dW| within 1e-4 of max |W|,
    tests/test_torch_online.py), not bitwise. The step launches the
    kernel once a replica chunk."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.online import OnlineUpdater
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(4000, 12, 4, seed=1, class_sep=0.5)
    kw = dict(n_estimators=8, seed=0, chunk_size=8)
    learner = LogisticRegression(max_iter=1, hessian_impl="pallas")
    card = BaggingClassifier(learner, device="cuda", **kw).fit(X[:3000],
                                                               y[:3000])
    cpu = BaggingClassifier(learner, device="cpu", **kw).fit(X[:3000],
                                                             y[:3000])
    cpu.ensemble_ = {k: v.cpu() for k, v in card.ensemble_.items()}
    before = scaled_grams.launches
    W = {}
    for name, est in (("card", card), ("cpu", cpu)):
        upd = OnlineUpdater(est)
        rep = upd.partial_fit(X[3000:], y[3000:])
        W[name] = upd.to_estimator().ensemble_["W"].cpu()
        assert rep["oob_rows"] > 0
    assert scaled_grams.launches - before == 1
    assert _rel_err(W["card"], W["cpu"]) <= 1e-4


def test_csv_stream_on_card_equals_the_array_stream(cuda, tmp_path):
    """A CSV written with %.9g, streamed through ``CSVChunks`` (the host
    loader), fits bitwise the same ensemble on the card as the same
    rows through ``ArrayChunks``: the chunks are bitwise equal and the
    device steps are the same launches."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.utils.datasets import make_classification
    from spark_bagging_tpu_torch.utils.io import ArrayChunks, CSVChunks

    X, y = make_classification(3000, 8, 2, seed=2)
    path = tmp_path / "rows.csv"
    np.savetxt(path, np.c_[X, y], fmt="%.9g", delimiter=",")
    fits = [BaggingClassifier(LogisticRegression(l2=1e-4), n_estimators=8,
                              seed=0, device="cuda").fit_stream(
        src, classes=[0, 1], steps_per_chunk=2, lr=0.05)
        for src in (CSVChunks(str(path), 512),
                    ArrayChunks(X, y.astype(np.float32), 512))]
    for k in fits[0].ensemble_:
        assert torch.equal(fits[0].ensemble_[k], fits[1].ensemble_[k]), k


# -- the quality plane's disagreement tap and the online trainer ----------

@pytest.mark.parametrize("name", ["logistic", "logistic_chunked",
                                  "tree_hard", "gbt_multiclass", "mlp",
                                  "ridge"])
def test_quality_replica_graphs_equal_the_eager_replica_forward(cuda, name):
    """One CUDA graph a bucket for the per-replica forward, captured at
    ``warmup_replica`` and counted apart from the serving captures: each
    replay is bit for bit the same closure run eagerly at that bucket,
    and its mean (soft vote, regression) or vote count (hard vote) is
    the served output."""
    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import EnsembleExecutor, program_cache
    from spark_bagging_tpu_torch.serving.executor import pool_reserved_bytes

    est, X = _serving_model(name)
    # an earlier test's executor of the same weights, not yet collected,
    # would lend its captures (and their bytes in its own pool)
    program_cache.clear()
    ex = EnsembleExecutor(est, min_bucket_rows=1, max_batch_rows=64)
    ex.warmup()
    reg = telemetry.registry()
    serving0 = reg.counter("sbt_serving_compiles_total").value
    tap0 = reg.counter("sbt_quality_disagreement_compiles_total").value
    pool0 = ex.graph_pool_bytes
    assert ex.warmup_replica() == ex.compiled_buckets
    assert reg.counter("sbt_serving_compiles_total").value == serving0
    assert reg.counter("sbt_quality_disagreement_compiles_total").value \
        - tap0 == len(ex.compiled_buckets)
    progs = [ex.replica_program(b) for b in ex.replica_buckets]
    assert ex.graph_pool_bytes > pool0
    static = sum(p.x.nbytes + p.out.nbytes for p in progs) + sum(
        ex.program(b).x.nbytes + ex.program(b).out.nbytes
        for b in ex.compiled_buckets)
    assert ex.graph_pool_bytes == pool_reserved_bytes(ex._pool) + static
    fn, params, subs = est.replica_forward()
    for b in ex.replica_buckets:
        Xb = np.ascontiguousarray(X[:b], np.float32)
        eager = fn(params, subs, torch.from_numpy(Xb).to(cuda)).cpu().numpy()
        rep = ex.replica_program(b).run(Xb, b)
        np.testing.assert_array_equal(rep, eager)
        served = ex.forward(Xb)
        if getattr(est, "voting", None) == "hard":
            np.testing.assert_array_equal(
                rep.sum(0), np.rint(served * est.n_estimators_))
        else:
            np.testing.assert_allclose(rep.mean(0), served, rtol=1e-5,
                                       atol=1e-6)


def test_quality_tap_serves_bitwise_and_captures_only_at_warmup(cuda):
    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import ModelRegistry

    est, X = _serving_model("logistic")
    reg = ModelRegistry(min_bucket_rows=1, max_batch_rows=64)
    ex = reg.register("m", est, warmup=True)
    sizes = [1, 3, 17, 64, 100]
    base = [ex.forward(X[:n]) for n in sizes]
    mon = reg.enable_quality("m", refresh_every=1, disagreement_every=1)
    assert ex.replica_buckets == ex.compiled_buckets
    r = telemetry.registry()
    c0 = (r.counter("sbt_serving_compiles_total").value,
          r.counter("sbt_quality_disagreement_compiles_total").value)
    with reg.batcher("m", max_delay_ms=0.5) as b:
        got = [b.submit(X[:n]).result(30) for n in sizes]
    for g, w in zip(got, base):
        np.testing.assert_array_equal(g, w)
    assert (r.counter("sbt_serving_compiles_total").value,
            r.counter("sbt_quality_disagreement_compiles_total").value) == c0
    assert mon.summary()["rows_observed"] == sum(sizes)
    assert mon.summary()["disagreement_samples"] == len(sizes)
    # a swap pre-captures the replacement's tap before its commit
    est2, _ = _serving_model("logistic", seed=1)
    new = reg.swap("m", est2)
    assert new.replica_buckets == new.compiled_buckets
    assert new.quality is not None and new.quality is not mon


def test_quality_failed_replica_capture_raises_at_warmup(cuda):
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    est, X = _serving_model("logistic")
    rep_fn, params, subs = est.replica_forward()

    def syncing(p, s, x):
        out = rep_fn(p, s, x)
        if float(out.sum().item()) < -1.0:  # host sync inside the forward
            out = out * 2
        return out

    class Syncing:
        task, n_features_in_, classes_ = est.task, est.n_features_in_, \
            est.classes_
        aggregated_forward = staticmethod(est.aggregated_forward)

        def replica_forward(self):
            return syncing, params, subs

    ex = EnsembleExecutor(Syncing(), min_bucket_rows=4, max_batch_rows=4)
    ex.warmup()
    with pytest.raises(RuntimeError, match="per-replica forward"):
        ex.warmup_replica()
    assert ex.replica_buckets == ()
    np.testing.assert_array_equal(ex.forward(X[:3]),
                                  est.aggregated_forward()[0](
                                      params, subs,
                                      torch.from_numpy(X[:3]).to(cuda)
                                  ).cpu().numpy())


def test_trainer_refit_on_card_matches_cpu(cuda, tmp_path):
    """One drift-triggered refit cycle of ``OnlineTrainer`` on the card
    and on the CPU from the same incumbent (the CPU twin carries the
    card's params) over the same labeled window: the refit's Newton
    Hessians run the scaled-Gram kernel on the card, and the published
    params are held within 1e-4 of max |W|, as the online steps are."""
    from spark_bagging_tpu_torch import BaggingClassifier, LogisticRegression
    from spark_bagging_tpu_torch.online import LabeledBuffer, OnlineTrainer
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.serving import ModelRegistry
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    # tests/test_torch_online.py's data (class_sep 0.5): a separable
    # window sends Newton's iterates toward infinity in both packages,
    # where last-bit differences grow without bound
    X, y = make_classification(4000, 12, 4, seed=1, class_sep=0.5)
    learner = LogisticRegression(max_iter=1, hessian_impl="pallas")
    kw = dict(n_estimators=8, seed=0, chunk_size=8)
    card = BaggingClassifier(learner, device="cuda", **kw).fit(X[:3000],
                                                               y[:3000])
    cpu = BaggingClassifier(learner, device="cpu", **kw).fit(X[:3000],
                                                             y[:3000])
    cpu.ensemble_ = {k: v.cpu() for k, v in card.ensemble_.items()}
    W, records = {}, {}
    for name, est in (("card", card), ("cpu", cpu)):
        reg = ModelRegistry(min_bucket_rows=8, max_batch_rows=64)
        reg.register("m", est, warmup=True)
        buf = LabeledBuffer(capacity_rows=1000)
        buf.add(X[3000:], y[3000:])
        trainer = OnlineTrainer(reg, "m", buf, epochs=1, batch_rows=1000,
                                margin=1.0, seed=0,
                                publish_dir=str(tmp_path / name))
        before = scaled_grams.launches
        trainer.trigger(reason="drift")
        (records[name],) = trainer.run_pending()
        if name == "card":
            # one warm Newton step over the window, one replica chunk
            assert scaled_grams.launches - before == 1
        W[name] = reg.model("m").ensemble_["W"].cpu()
    assert records["card"]["action"] == records["cpu"]["action"] == \
        "published"
    assert _rel_err(W["card"], W["cpu"]) <= 1e-4


# -- the operator's planes on the card --------------------------------------

def test_capacity_ledger_reconciles_with_graph_pool_bytes(cuda):
    # the ledger's compiled bytes are the registry executors' captured
    # programs' bytes, exactly; params_bytes the parameter and subspace
    # tensors'
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache
    from spark_bagging_tpu_torch.telemetry import capacity

    program_cache.clear()
    plane = capacity.enable()
    try:
        reg = ModelRegistry(min_bucket_rows=1, max_batch_rows=64)
        exs = {}
        for name in ("logistic", "tree_hard"):
            est, X = _serving_model(name)
            exs[name] = reg.register(name, est, warmup=True)
            exs[name].forward(X[:5])
        led = plane.ledger()
        assert led["reconciled"] is True
        for name, ex in exs.items():
            assert led["owners"][name]["bytes"] == ex.graph_pool_bytes > 0
            assert led["owners"][name]["unmeasured"] == 0
            rec = led["committed"][f"{name}@1"]
            assert rec["placement"] == "cuda"
            assert rec["params_bytes"] == capacity.params_nbytes(ex)
        rows = capacity.capacity_report()["residents"]
        assert {r["bytes_source"] for r in rows} == {"graph_pool"}
    finally:
        capacity.disable()


@pytest.mark.parametrize("name", ["logistic", "tree_hard"])
def test_bucket_flops_on_the_card_equal_the_cpus(cuda, name):
    from spark_bagging_tpu_torch.serving import EnsembleExecutor

    ests = [_serving_model(name, device=d)[0] for d in ("cuda", "cpu")]
    costs = []
    for est in ests:
        ex = EnsembleExecutor(est, min_bucket_rows=1, max_batch_rows=64)
        ex.warmup()
        costs.append(ex.bucket_costs)
    assert costs[0] == costs[1]
    flops = {c["flops"] for c in costs[0].values()}
    assert (flops == {None}) == (name == "tree_hard")


def test_a_scrape_never_initializes_cuda(cuda):
    # a process that starts the server and scrapes every route that
    # reads device state leaves torch.cuda uninitialized
    import os
    import subprocess
    import sys

    code = (
        "import json, urllib.request, torch\n"
        "from spark_bagging_tpu_torch import telemetry\n"
        "from spark_bagging_tpu_torch.telemetry import capacity\n"
        "capacity.enable()\n"
        "port = telemetry.start_server(port=0)\n"
        "for p in ('/metrics', '/varz', '/healthz', '/debug/capacity',\n"
        "          '/debug/tail'):\n"
        "    urllib.request.urlopen(f'http://127.0.0.1:{port}{p}',\n"
        "                           timeout=10).read()\n"
        "telemetry.stop_server()\n"
        "print(json.dumps(torch.cuda.is_initialized()))\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("SBT_METRICS_PORT", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "false"


# -- the tenancy plane on the card ------------------------------------------

class _PinnedPlane:
    """A demand plane that holds one tenant hot (pinned resident)."""

    def __init__(self, hot):
        self.hot = hot

    def owner_label(self, fingerprint):
        return None

    def demand_class(self, owner):
        return "hot" if owner == self.hot else "cold"


def _solo_forward(est, X, ladder):
    # a never-demoted executor of its own, built into a cache of its own
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache

    prev = program_cache.install(program_cache.ProgramCache())
    try:
        reg = ModelRegistry(**ladder)
        reg.register("solo", est, warmup=True)
        return reg.executor("solo").forward(X)
    finally:
        program_cache.install(prev)


def test_tenancy_demote_restore_round_trip_on_the_card(cuda):
    # capacity 1 over two tenants: each touch demotes the other. A
    # restore re-captures exactly the recorded ladder (counted), a
    # demoted tenant's graphs die and its graph_pool_bytes read 0, the
    # ledger equals the resident's graph_pool_bytes, and the answers are
    # bitwise a never-demoted solo executor's
    import gc
    import tempfile
    import weakref

    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache
    from spark_bagging_tpu_torch.telemetry import capacity
    from spark_bagging_tpu_torch.tenancy import TenantFleet, TenantSpec

    ladder = dict(min_bucket_rows=1, max_batch_rows=64)
    models = {"a": _serving_model("logistic")[0],
              "b": _serving_model("tree_hard")[0]}
    X = _serving_model("logistic")[1][:37]
    solo = {t: _solo_forward(m, X, ladder) for t, m in models.items()}
    prev_cache = program_cache.install(program_cache.ProgramCache())
    plane = capacity.enable()
    try:
        reg = ModelRegistry(**ladder)
        fleet = TenantFleet([TenantSpec(name=t) for t in models],
                            registry=reg, residency_capacity=1,
                            aot_root=tempfile.mkdtemp(), plane=plane)
        for t, m in models.items():
            fleet.register(t, m, warmup=True)
        n_rungs = len(reg.executor("b").compiled_buckets)
        assert n_rungs == 7 and reg.executor("a").graph_pool_bytes == 0
        c = telemetry.registry().counter("sbt_serving_compiles_total")
        for t, other in (("a", "b"), ("b", "a"), ("a", "b")):
            graphs = [weakref.ref(reg.executor(other).program(b).graph)
                      for b in reg.executor(other).compiled_buckets]
            c0 = c.value
            assert fleet.residency.touch(t) == "restored"
            assert c.value - c0 == n_rungs
            gc.collect()
            torch.cuda.synchronize()
            assert all(g() is None for g in graphs)
            assert reg.executor(other).graph_pool_bytes == 0
            ex = reg.executor(t)
            led = plane.ledger()
            assert led["reconciled"]
            assert led["cache"]["bytes"] == ex.graph_pool_bytes > 0
            assert np.array_equal(ex.forward(X), solo[t])
        assert c.value - c0 == n_rungs  # the forwards captured nothing
        fleet.close()
    finally:
        capacity.disable()
        program_cache.install(prev_cache)


def test_tenancy_threaded_restore_while_another_tenant_replays(cuda):
    # one thread replays tenant "a" (held hot, so never the victim) while
    # the main thread restores "b" and "c" in turn, each restore
    # capturing on the main thread and demoting the other: no request
    # fails and every answer is bitwise
    import tempfile
    import threading

    from spark_bagging_tpu_torch.serving import ModelRegistry, program_cache
    from spark_bagging_tpu_torch.tenancy import TenantFleet, TenantSpec

    ladder = dict(min_bucket_rows=1, max_batch_rows=64)
    models = {"a": _serving_model("logistic", seed=0)[0],
              "b": _serving_model("logistic", seed=1)[0],
              "c": _serving_model("tree_hard", seed=2)[0]}
    X = _serving_model("logistic")[1][:64]
    solo = {t: _solo_forward(m, X, ladder) for t, m in models.items()}
    # the hammer's requests of n rows run at n's own bucket
    solo_a = [_solo_forward(models["a"], X[:n], ladder)
              for n in range(1, 65)]
    prev_cache = program_cache.install(program_cache.ProgramCache())
    try:
        reg = ModelRegistry(**ladder)
        fleet = TenantFleet([TenantSpec(name=t) for t in models],
                            registry=reg, residency_capacity=2,
                            aot_root=tempfile.mkdtemp(),
                            plane=_PinnedPlane("a"), threaded=True,
                            batcher_opts=dict(max_delay_ms=0.5))
        for t, m in models.items():
            fleet.register(t, m, warmup=True)
        errors, served, stop = [], [0], threading.Event()
        b = fleet.batcher("a")

        def hammer():
            try:
                while not stop.is_set():
                    n = 1 + served[0] % 64
                    got = b.submit(X[:n]).result(60)
                    if not np.array_equal(got, solo_a[n - 1]):
                        errors.append(n)
                    served[0] += 1
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        th = threading.Thread(target=hammer)
        th.start()
        try:
            for k in range(8):
                t = "b" if k % 2 == 0 else "c"
                assert fleet.residency.touch(t) == "restored"
                assert "a" in fleet.residency.residents()
                assert np.array_equal(reg.executor(t).forward(X), solo[t])
        finally:
            stop.set()
            th.join(120)
        assert not errors and not th.is_alive() and served[0] > 0
        assert fleet.residency.counts()["restores"] == {"b": 4, "c": 4}
        fleet.close()
    finally:
        program_cache.install(prev_cache)


# -- the in-process mesh on the card ------------------------------------

@pytest.mark.parametrize("kind", ["logistic", "gini_tree"])
def test_threaded_data_mesh_fit_on_the_card(cuda, kind):
    """A (2, 2) mesh over repeated ``cuda:0`` entries: four shard threads
    launch the kernels (the Gram for logistic, the histogram and the bin
    codes for trees), each counted under its shard; with ``bootstrap=
    False`` the logistic fit is the single-device fit within 1e-5 and
    the trees, grown under the mesh's averaged edges, are the
    single-device trees grown under those edges, bit for bit."""
    import spark_bagging_tpu_torch as T
    from spark_bagging_tpu_torch.ops.gram import scaled_grams
    from spark_bagging_tpu_torch.ops.hist import binned_left_stats, bin_codes
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(4000, 12, 3, seed=0)
    mesh = T.make_mesh(2, devices=[cuda] * 4)
    kw = dict(n_estimators=8, bootstrap=False, max_samples=1.0, seed=0,
              device="cuda")
    if kind == "logistic":
        learner = T.LogisticRegression(max_iter=4, hessian_impl="pallas")
        fns = (scaled_grams,)
    else:
        learner = T.DecisionTreeClassifier(max_depth=4, n_bins=32,
                                           split_impl="fused")
        fns = (binned_left_stats, bin_codes)
    for fn in fns:
        fn.__dict__.pop("shard_launches", None)
    a = T.BaggingClassifier(learner, mesh=mesh, **kw).fit(X, y)
    for fn in fns:
        shards = {s for (attr, s) in fn.shard_launches if attr == "launches"}
        assert shards == {(0, 0), (0, 1), (1, 0), (1, 1)}, fn.__name__
    if kind == "logistic":
        b = T.BaggingClassifier(learner, **kw).fit(X, y)
        np.testing.assert_allclose(a.predict_proba(X), b.predict_proba(X),
                                   atol=1e-5)
        return
    # the mesh's edges, then a single-device growth under them
    from spark_bagging_tpu_torch.ensemble import fit_ensemble
    from spark_bagging_tpu_torch.ops import prng

    edges = {}
    orig = type(learner).prepare

    def record(self, Xs, *, row_mask=None, axis_name=None):
        out = orig(self, Xs, row_mask=row_mask, axis_name=axis_name)
        edges["E"] = out["edges"]
        return out

    type(learner).prepare = record
    try:
        T.BaggingClassifier(learner, mesh=mesh, **kw).fit(X, y)
    finally:
        type(learner).prepare = orig
    Xt = torch.as_tensor(X, device=cuda)
    learner.prepare = lambda Xs, *, row_mask=None: learner._binned(
        Xs, edges["E"])
    try:
        params, _, _ = fit_ensemble(
            learner, Xt, torch.as_tensor(y, device=cuda), prng.key(0, cuda),
            torch.arange(8, device=cuda), 3, bootstrap=False)
    finally:
        del learner.prepare
    for k in ("feature", "threshold", "gain", "leaf_logp"):
        assert torch.equal(a.ensemble_[k], params[k]), k


def test_mesh_serving_on_the_card_with_a_shard_loss(cuda):
    """``EnsembleExecutor(mesh=(1, 4))`` on ``cuda:0`` x 4: one graph per
    (bucket, shard) captured at warm-up and none on requests, every
    bucket bitwise the single-device executor's, and the ``shard-loss``
    plan degrading to the surviving subset's aggregate, bitwise, with no
    request failing."""
    import warnings

    import spark_bagging_tpu_torch as T
    from spark_bagging_tpu_torch import faults, telemetry
    from spark_bagging_tpu_torch.parallel.sharded import (
        replica_subset_serving,
    )
    from spark_bagging_tpu_torch.serving import EnsembleExecutor
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(2000, 16, 4, seed=1)
    clf = T.BaggingClassifier(T.LogisticRegression(max_iter=4),
                              n_estimators=16, device="cuda").fit(X, y)
    telemetry.enable()
    c = telemetry.registry().counter("sbt_serving_compiles_total")
    single = EnsembleExecutor(clf, min_bucket_rows=1, max_batch_rows=64)
    sharded = EnsembleExecutor(clf, min_bucket_rows=1, max_batch_rows=64,
                               mesh=T.make_mesh(replica=4,
                                                devices=[cuda] * 4))
    single.warmup()
    sharded.warmup()
    c0 = c.value
    for b in (1, 2, 4, 8, 16, 32, 64):
        np.testing.assert_array_equal(sharded.forward(X[:b]),
                                      single.forward(X[:b]))
    assert c.value == c0
    fn, _rf, p, s = replica_subset_serving(
        clf, [i for i in range(16) if i // 4 != 1])
    faults.arm(faults.builtin_plan("shard-loss"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            outs = [sharded.forward(X[k * 8:k * 8 + 8]) for k in range(6)]
    finally:
        faults.disarm()
    assert sharded.failed_shards == (1,)
    for k in range(3, 6):
        want = fn(p, s, torch.as_tensor(X[k * 8:k * 8 + 8],
                                        device=cuda)).cpu().numpy()
        np.testing.assert_array_equal(outs[k], want)


def test_data_mesh_newton_fits_in_a_fresh_process_on_the_card(cuda):
    """LinearSVC and GLM on a (4, 1) mesh over ``cuda:0`` x 4, in a fresh
    process whose first Cholesky and Cholesky solve run in the shard
    threads: no lazy-loader race ("lazy wrapper should be called at most
    once"), and with ``bootstrap=False`` each fit is the single-device
    fit within its CPU parity tolerance (tests/test_torch_zoo_*.py)."""
    import subprocess
    import sys

    script = """
import numpy as np, torch
import spark_bagging_tpu_torch as T
from spark_bagging_tpu_torch.utils.datasets import make_classification
X, y = make_classification(4000, 12, 3, seed=0)
mesh = T.make_mesh(4, devices=[torch.device("cuda")] * 4)
kw = dict(n_estimators=8, bootstrap=False, max_samples=1.0, seed=0)
svc = [T.BaggingClassifier(T.LinearSVC(max_iter=5), mesh=m, **kw).fit(X, y)
       for m in (mesh, None)]
d = np.abs(svc[0].predict_proba(X) - svc[1].predict_proba(X)).max()
assert d <= 1e-4, d
yr = X[:, 0] - 0.5 * X[:, 1]
glm = [T.BaggingRegressor(T.GeneralizedLinearRegression(max_iter=5),
                          mesh=m, **kw).fit(X, yr) for m in (mesh, None)]
d = np.abs(glm[0].predict(X) - glm[1].predict(X)).max()
assert d <= 5e-4 * max(1.0, np.abs(glm[1].predict(X)).max()), d
print("ok")
"""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("engine", ["sgd", "tree"])
def test_mesh_stream_fit_on_the_card(cuda, engine):
    """``fit_stream(mesh=(2, 2))`` over ``cuda:0`` x 4. The SGD engine
    (MLP): its probabilities within 1e-4 of the single-device stream's
    (the gradients summed over two row shards in another order). The
    tree engine with ``bootstrap=False``: bitwise the single-device
    stream, the histogram and bin codes launched by all four shards,
    levels x chunks each."""
    import spark_bagging_tpu_torch as T
    from spark_bagging_tpu_torch.ops.hist import bin_codes, binned_left_stats
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    X, y = make_classification(6000, 12, 3, seed=2)
    mesh = T.make_mesh(2, devices=[cuda] * 4)
    if engine == "sgd":
        est = dict(n_estimators=16, seed=0, device="cuda")
        fit = dict(chunk_rows=1000, n_epochs=2, steps_per_chunk=2, lr=0.01,
                   prefetch=0)
        fits = [T.BaggingClassifier(T.MLPClassifier(hidden=16), mesh=m,
                                    **est).fit_stream((X, y), **fit)
                for m in (mesh, None)]
        np.testing.assert_allclose(fits[0].predict_proba(X),
                                   fits[1].predict_proba(X), atol=1e-4)
        assert fits[0].fit_report_["n_devices"] == 4
        return
    est = dict(n_estimators=16, seed=0, bootstrap=False, max_features=0.8,
               device="cuda")
    learner = T.DecisionTreeClassifier(max_depth=4, n_bins=32)
    for fn in (binned_left_stats, bin_codes):
        fn.__dict__.pop("shard_launches", None)
    a = T.BaggingClassifier(learner, mesh=mesh, **est).fit_stream(
        (X, y), chunk_rows=2048, prefetch=0)
    for fn in (binned_left_stats, bin_codes):
        per = {s: v for (attr, s), v in fn.shard_launches.items()
               if attr == "launches"}
        assert per == {s: 4 * 3 for s in ((0, 0), (0, 1), (1, 0), (1, 1))}
    b = T.BaggingClassifier(learner, **est).fit_stream(
        (X, y), chunk_rows=2048, prefetch=0)
    for k, v in b.ensemble_.items():
        assert torch.equal(a.ensemble_[k], v), k


_MP_FITS = """
def fits(T, mesh, make_classification):
    import numpy as np
    X, y = make_classification(4000, 12, 3, seed=4)
    out = {}
    for name, learner in (
            ("logistic", T.LogisticRegression(max_iter=2, init="pooled",
                                              hessian_impl="pallas")),
            ("trees", T.DecisionTreeClassifier(max_depth=3, n_bins=16,
                                               split_impl="fused"))):
        est = T.BaggingClassifier(learner, n_estimators=8, seed=0,
                                  max_features=0.8, mesh=mesh).fit(X, y)
        out.update({f"{name}.{k}": v.cpu().numpy()
                    for k, v in est.ensemble_.items()})
        out[f"{name}.pred"] = est.predict_proba(X)
    stream = T.BaggingClassifier(T.MLPClassifier(hidden=8), n_estimators=8,
                                 seed=0, mesh=mesh)
    stream.fit_stream((X, y), chunk_rows=1000, n_epochs=2, prefetch=0)
    out.update({f"stream.{k}": v.cpu().numpy()
                for k, v in stream.ensemble_.items()})
    return out
"""

_MP_WORKER = _MP_FITS + """
import sys
import numpy as np
import spark_bagging_tpu_torch as T
from spark_bagging_tpu_torch.parallel import initialize_distributed, make_mesh
from spark_bagging_tpu_torch.utils.datasets import make_classification
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_distributed(f"127.0.0.1:{port}", 2, pid, timeout_s=60)
mesh = make_mesh(2, 2, devices=["cuda:0"] * 2)
np.savez(f"{out}/p{pid}.npz", **fits(T, mesh, make_classification))
"""


def test_two_process_mesh_on_the_card_is_bitwise_the_one_process_mesh(
        cuda, tmp_path):
    """Two processes joined over gloo, each with ``cuda:0`` x 2 of one
    (2, 2) mesh: the collectives staged through the host. The pooled
    logistic fit (the scaled-Gram kernel), the fused trees (the
    histogram kernel) and an MLP stream are bitwise the 1-process (2, 2)
    mesh over ``cuda:0`` x 4 in this process, in both processes."""
    import os
    import socket
    import subprocess
    import sys

    import spark_bagging_tpu_torch as T
    from spark_bagging_tpu_torch.utils.datasets import make_classification

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logs = [open(tmp_path / f"log{pid}", "w+") for pid in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MP_WORKER, str(pid), str(port),
         str(tmp_path)], cwd=root, stdout=log, stderr=log)
        for pid, log in enumerate(logs)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for code, log in zip(codes, logs):
        log.seek(0)
        assert code == 0, log.read()[-4000:]
        log.close()
    scope: dict = {}
    exec(_MP_FITS, scope)
    want = scope["fits"](T, T.make_mesh(2, 2, devices=[cuda] * 4),
                         make_classification)
    for pid in range(2):
        with np.load(tmp_path / f"p{pid}.npz") as got:
            assert sorted(got.files) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=f"{pid} {k}")
