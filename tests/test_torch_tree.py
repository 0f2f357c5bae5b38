"""The port's trees and random forests against the JAX package.

Tiers (small sizes: at most 600 rows, depth 4, 16 bins, 8 replicas, so
every Gini sum of squared counts stays below 2**24):
- bitwise: the split ``feature``, ``threshold`` and ``gain`` of Gini
  trees, both ``split_impl``; quantile edges; per-split feature masks;
  OOB membership and score. Integer counts make every sum exact, and
  the Gini score is the same IEEE operations on the same floats;
- ``leaf_logp`` within 2 ulps: the leaf counts are exact, but XLA's and
  torch's float32 ``log`` differ by up to an ulp on ~13% of inputs;
- ``predict_proba`` and ``feature_importances_`` within 1e-6 (a softmax
  or a normalization of the above);
- entropy trees and regression trees: their split scores go through
  ``log`` or float moment sums summed in another order, so they may
  differ by ulps; on this data the chosen splits are still equal, and
  leaf values agree within 1e-5 relative.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.models import tree as jtree  # noqa: E402
from spark_bagging_tpu.ops import bootstrap as jboot  # noqa: E402
from spark_bagging_tpu_torch.models import tree as ttree  # noqa: E402
from spark_bagging_tpu_torch.ops import bootstrap as tboot  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import make_classification  # noqa: E402

TREE = dict(max_depth=4, n_bins=16)
PROBA_ATOL = 1e-6


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_trees_equal(jparams, tparams, leaf="leaf_logp"):
    for k in ("feature", "threshold", "gain"):
        a, b = np.asarray(jparams[k]), _np(tparams[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_max_ulp(np.asarray(jparams[leaf]),
                                    _np(tparams[leaf]), maxulp=2)


@pytest.fixture(scope="module")
def data():
    return make_classification(600, 10, 3, seed=0)


@pytest.fixture(scope="module", params=["dense", "fused"])
def both_fits(request, data):
    X, y = data
    est = dict(n_estimators=6, max_features=0.8, oob_score=True, seed=0)
    jc = J.BaggingClassifier(
        J.DecisionTreeClassifier(split_impl=request.param, **TREE), **est
    ).fit(X, y)
    tc = T.BaggingClassifier(
        T.DecisionTreeClassifier(split_impl=request.param, **TREE),
        device="cpu", **est,
    ).fit(X, y)
    return X, y, jc, tc


def test_bagged_trees_match_jax(both_fits):
    X, _, jc, tc = both_fits
    np.testing.assert_array_equal(np.asarray(jc.subspaces_),
                                  tc.subspaces_.numpy())
    assert tc.subspaces_.shape == (6, 8)
    assert_trees_equal(jc.ensemble_, tc.ensemble_)
    np.testing.assert_allclose(tc.predict_proba(X), jc.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)


def test_hard_vote_matches_jax(both_fits):
    X, y, jc, tc = both_fits
    jc.set_params(voting="hard")
    tc.set_params(voting="hard")
    try:
        pj, pt = jc.predict_proba(X), tc.predict_proba(X)
        assert tc.score(X, y) == jc.score(X, y)
    finally:
        jc.set_params(voting="soft")
        tc.set_params(voting="soft")
    # vote frequencies are multiples of 1/6: a flipped vote shows as 0.17
    np.testing.assert_allclose(pt, pj, atol=PROBA_ATOL, rtol=0)


def test_oob_and_importances_match_jax(both_fits):
    _, _, jc, tc = both_fits
    assert tc.oob_score_ == jc.oob_score_
    np.testing.assert_allclose(tc.oob_decision_function_,
                               jc.oob_decision_function_, atol=PROBA_ATOL)
    imp = tc.feature_importances_
    assert imp.shape == (10,) and abs(imp.sum() - 1.0) < 1e-9
    np.testing.assert_allclose(imp, jc.feature_importances_, atol=1e-6)


def test_dense_fused_and_chunked_fits_are_identical(data):
    X, y = data
    fits = [
        T.BaggingClassifier(
            T.DecisionTreeClassifier(split_impl=impl, **TREE),
            n_estimators=5, max_features=0.7, seed=2, chunk_size=chunk,
            device="cpu",
        ).fit(X, y)
        for impl, chunk in (("dense", None), ("fused", None), ("fused", 2))
    ]
    for other in fits[1:]:
        for k in ("feature", "threshold", "gain", "leaf_logp"):
            assert torch.equal(fits[0].ensemble_[k], other.ensemble_[k]), k


def test_entropy_trees_match_jax(data):
    X, y = data
    kw = dict(criterion="entropy", min_instances_per_node=2.0, **TREE)
    est = dict(n_estimators=4, seed=1)
    jc = J.BaggingClassifier(J.DecisionTreeClassifier(**kw), **est).fit(X, y)
    tc = T.BaggingClassifier(T.DecisionTreeClassifier(**kw), device="cpu",
                             **est).fit(X, y)
    np.testing.assert_array_equal(np.asarray(jc.ensemble_["feature"]),
                                  tc.ensemble_["feature"].numpy())
    np.testing.assert_array_equal(np.asarray(jc.ensemble_["threshold"]),
                                  tc.ensemble_["threshold"].numpy())
    np.testing.assert_allclose(tc.ensemble_["gain"].numpy(),
                               np.asarray(jc.ensemble_["gain"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc.predict_proba(X), jc.predict_proba(X),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("voting,min_info_gain", [("soft", 0.0),
                                                  ("hard", 5.0)])
def test_random_forest_matches_jax(data, voting, min_info_gain):
    X, y = data
    kw = dict(n_estimators=5, max_depth=3, n_bins=16, feature_subset="sqrt",
              voting=voting, oob_score=True, seed=4,
              min_info_gain=min_info_gain)
    jf = J.RandomForestClassifier(**kw).fit(X, y)
    tf = T.RandomForestClassifier(device="cpu", **kw).fit(X, y)
    assert tf.get_params()["feature_subset"] == "sqrt"
    assert tf._fitted_learner._n_split_features(10) == 4
    # a gain floor turns weak nodes into leaves (threshold +inf)
    leaves = int(torch.isinf(tf.ensemble_["threshold"]).sum())
    assert (leaves > 0) == (min_info_gain > 0)
    assert_trees_equal(jf.ensemble_, tf.ensemble_)
    np.testing.assert_allclose(tf.predict_proba(X), jf.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)
    assert tf.oob_score_ == jf.oob_score_
    np.testing.assert_allclose(tf.feature_importances_,
                               jf.feature_importances_, atol=1e-6)


@pytest.mark.parametrize("target", ["integer", "float"])
@pytest.mark.parametrize("feature_subset", [None, 0.5])
def test_regression_tree_learner_matches_jax(target, feature_subset):
    # learner level, a replica axis of 4 (BaggingRegressor is not ported)
    rng = np.random.default_rng(3)
    n, F, R = 400, 6, 4
    X = rng.standard_normal((n, F)).astype(np.float32)
    if target == "integer":
        # integer moments: every sum exact, so the trees are bitwise equal
        y = rng.integers(0, 10, n).astype(np.float32)
    else:
        y = (X[:, 0] * 2 + np.sin(X[:, 1]) + 0.3 * rng.standard_normal(n))
        y = y.astype(np.float32)
    W = rng.poisson(1.0, (R, n)).astype(np.float32)
    kw = dict(max_depth=3, n_bins=16, feature_subset=feature_subset,
              split_impl="fused")
    jl = J.DecisionTreeRegressor(**kw)
    ids = jnp.arange(R, dtype=jnp.int32)
    jkeys = jax.vmap(lambda r: jboot.fit_key(jax.random.key(0), r))(ids)
    prep = jl.prepare(jnp.asarray(X))
    jp, jaux = jax.vmap(lambda k, w: jl.fit_from_init(
        k, jnp.asarray(X), jnp.asarray(y), w, 1, prepared=prep))(
        jkeys, jnp.asarray(W))
    tl = T.DecisionTreeRegressor(**kw)
    tkeys = tboot.fit_key(prng.key(0), torch.arange(R))
    Xt = torch.from_numpy(X)
    tp, taux = tl.fit_from_init(tkeys, Xt, torch.from_numpy(y),
                                torch.from_numpy(W), 1,
                                prepared=tl.prepare(Xt))
    np.testing.assert_array_equal(np.asarray(jp["feature"]),
                                  tp["feature"].numpy())
    np.testing.assert_array_equal(np.asarray(jp["threshold"]),
                                  tp["threshold"].numpy())
    if target == "integer":
        assert_trees_equal(jp, tp, leaf="leaf_value")
    np.testing.assert_allclose(tp["leaf_value"].numpy(),
                               np.asarray(jp["leaf_value"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(taux["loss"].numpy(), np.asarray(jaux["loss"]),
                               rtol=1e-5)
    pred = tl.predict_scores(tp, Xt)
    assert pred.shape == (R, n)
    want = jax.vmap(lambda p: jl.predict_scores(p, jnp.asarray(X)))(jp)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_quantile_edges_match_jax():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((301, 5)).astype(np.float32)
    X[rng.integers(0, 301, 40), 2] = np.nan  # NaN sorts last
    X[:, 4] = np.round(X[:, 4])              # ties
    mask = (rng.uniform(size=301) > 0.2).astype(np.float32)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want, jn = jtree._quantile_edges(jnp.asarray(X), jm, 16)
        got, tn = ttree._quantile_edges(torch.from_numpy(X), tm, 16)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert int(jn) == int(tn)


def test_level_feature_masks_match_jax():
    ids = [0, 5, 3863]
    jkeys = [jboot.fit_key(jax.random.key(2), jnp.int32(r)) for r in ids]
    tkeys = tboot.fit_key(prng.key(2), torch.tensor(ids))
    for level, N, F, k in ((0, 1, 10, 4), (2, 4, 10, 3), (3, 8, 43, 7)):
        got = ttree._TreeBase._level_feat_mask(tkeys, level, N, F, k)
        assert got.shape == (3, N, F) and (got.sum(-1) == k).all()
        for i, jk in enumerate(jkeys):
            want = jtree._TreeBase._level_feat_mask(jk, level, N, F, k)
            np.testing.assert_array_equal(np.asarray(want), got[i].numpy())


def test_jax_tree_ensemble_carried_across_predicts_like_jax(data):
    X, y = data
    jf = J.RandomForestClassifier(n_estimators=4, max_depth=3, n_bins=16,
                                  seed=0).fit(X, y)
    ens = {k: np.asarray(v) for k, v in jf.ensemble_.items()}
    port = T.BaggingClassifier.from_jax_arrays(
        ens, np.asarray(jf.subspaces_), classes=jf.classes_,
        n_features=jf.n_features_in_, device="cpu",
        base_learner=T.DecisionTreeClassifier(max_depth=3, n_bins=16),
    )
    assert port.ensemble_["feature"].dtype == torch.int32
    assert port.ensemble_["threshold"].dtype == torch.float32
    np.testing.assert_allclose(port.predict_proba(X), jf.predict_proba(X),
                               atol=PROBA_ATOL, rtol=0)
    np.testing.assert_allclose(port.feature_importances_,
                               jf.feature_importances_, atol=1e-6)


def test_params_from_jax_keeps_integer_leaves():
    from spark_bagging_tpu_torch.convert import params_from_jax

    params, subs = params_from_jax(
        {"feature": np.array([[3, 1]], np.int32),
         "threshold": np.array([[0.5, np.inf]], np.float64)},
        np.array([[0, 1, 2, 3]], np.int32), device="cpu")
    assert params["feature"].dtype == torch.int32
    assert params["feature"].tolist() == [[3, 1]]
    assert params["threshold"].dtype == torch.float32
    assert subs.dtype == torch.int32


def test_resolved_impl_and_hist_dtype():
    t = T.DecisionTreeClassifier()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    # "auto": the kernel on the card at any size, the dense product on the CPU
    assert t._resolved_impl(cuda) == "fused"
    assert t._resolved_impl(cpu) == "dense"
    assert t._resolved_impl(None) == "dense"
    assert T.DecisionTreeClassifier(
        split_impl="dense")._resolved_impl(cuda) == "dense"
    assert T.DecisionTreeClassifier(
        split_impl="fused")._resolved_impl(cpu) == "fused"
    assert t._hdt(cuda) == "bfloat16" and t._hdt(cpu) == "float32"
    assert T.DecisionTreeClassifier(hist_dtype="float32")._hdt(cuda) == "float32"


def test_memory_model_prices_the_tree_fit():
    from spark_bagging_tpu_torch.utils.memory import auto_chunk_size

    t = T.DecisionTreeClassifier(max_depth=5, n_bins=32)
    cuda = torch.device("cuda")
    n, F, k, C = 581_012, 54, 43, 7
    per = t.fit_workset_bytes(n, k, C, device=cuda)
    table = 4.0 * k * 32 * 16 * C
    leaf_onehot = 4.0 * n * 32
    assert per >= leaf_onehot + 4 * table + 2 * 4.0 * n * C
    # the kernel path reads the shared X through each replica's columns:
    # no per-replica copy; its uint8 bin codes are priced once (31 MB)
    gather = t.subspace_gather_bytes(n, k, device=cuda)
    assert gather == 0.0
    assert t.prepared_bytes(n, F, device=cuda) == 1.0 * n * F
    assert T.DecisionTreeClassifier(n_bins=300).prepared_bytes(
        n, F, device=cuda) == 2.0 * n * F  # int16 codes
    # the dense path gathers its int8 indicator slices and their bf16
    # copy, and keeps the shared indicator once
    dense = T.DecisionTreeClassifier(split_impl="dense")
    assert dense.subspace_gather_bytes(n, k, device=cuda) == 3.0 * n * k * 32
    assert dense.prepared_bytes(n, F, device=cuda) == 1.0 * n * F * 32
    budget = 10 * 2**30
    chunk = auto_chunk_size(t, n, k, C, 256, cuda, budget_bytes=budget,
                            n_features=F)
    assert chunk == int((budget - n * F) // (per + 48.0 * n))


@pytest.mark.parametrize("split_impl", ["fused", "dense"])
def test_shared_x_fit_equals_the_gathered_fit(data, split_impl, monkeypatch):
    # reads_subspace_index: the engine hands the shared X and the trees
    # read it (and the shared codes) through each replica's columns; a
    # learner that takes gathered copies instead (X[:, idx] and, on the
    # kernel path, per-replica codes) grows identical trees
    from spark_bagging_tpu_torch import ensemble

    class Gathered(T.DecisionTreeClassifier):
        reads_subspace_index = False

        def gather_subspace(self, prepared, idx):
            out = super().gather_subspace(prepared, idx)
            cols = out.pop("cols").long()
            if "codes" in out:
                out["codes"] = out["codes"][:, cols].permute(1, 0, 2).contiguous()
            return out

    X, y = data
    copies = []
    gather = ensemble._gather_columns
    monkeypatch.setattr(ensemble, "_gather_columns",
                        lambda *a: copies.append(1) or gather(*a))
    fits = {}
    for cls in (T.DecisionTreeClassifier, Gathered):
        del copies[:]
        fits[cls] = T.BaggingClassifier(
            cls(split_impl=split_impl, **TREE), n_estimators=5,
            max_features=0.7, bootstrap_features=True, seed=3, chunk_size=2,
            device="cpu").fit(X, y)
        # one X copy a chunk for the gathered learner, none for the tree
        assert len(copies) == (0 if cls is T.DecisionTreeClassifier else 3)
    a, b = fits[T.DecisionTreeClassifier], fits[Gathered]
    for key in ("feature", "threshold", "gain", "leaf_logp"):
        assert torch.equal(a.ensemble_[key], b.ensemble_[key]), key
    np.testing.assert_array_equal(a.predict_proba(X), b.predict_proba(X))


@pytest.mark.parametrize("scale,integral", [
    (1.0, True), (0.5, False), (2.0**23, False)])
def test_classifier_passes_integral_statistics(data, monkeypatch, scale,
                                               integral):
    # Poisson counts times one-hot classes are integers, summed in int32
    # on the card; fractional weights, or totals near int32's range, are
    # not
    from spark_bagging_tpu_torch.ops import hist

    X, y = data
    seen = []
    coded = hist.coded_left_stats
    monkeypatch.setattr(hist, "coded_left_stats", lambda *a, **kw: (
        seen.append(kw["integral"]) or coded(*a, **kw)))
    t = T.DecisionTreeClassifier(split_impl="fused", max_depth=2, n_bins=8)
    Xt = torch.from_numpy(X)
    w = torch.from_numpy(np.random.default_rng(0).poisson(
        1.0, (2, X.shape[0])).astype(np.float32)) * scale
    t.fit(t.init_params(tboot.fit_key(prng.key(0), torch.arange(2)), 10, 3),
          Xt, torch.from_numpy(y), w,
          tboot.fit_key(prng.key(0), torch.arange(2)))
    assert seen == [integral] * 2


def test_take_feature_through_columns_reads_the_gathered_values():
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.standard_normal((30, 6)).astype(np.float32))
    X[3, 2] = float("nan")
    cols = torch.tensor([[2, 0, 5], [1, 2, 3]], dtype=torch.int32)
    f_row = torch.from_numpy(rng.integers(0, 3, (2, 30)).astype(np.int32))
    Xg = X[:, cols.long()].permute(1, 0, 2).contiguous()
    got = ttree._take_feature(X, f_row, cols)
    want = ttree._take_feature(Xg, f_row)
    assert torch.equal(torch.nan_to_num(got, 9.0), torch.nan_to_num(want, 9.0))


def test_tree_hyperparams_validated():
    for kw in ({"max_depth": 0}, {"n_bins": 1}, {"split_impl": "magic"},
               {"hist_dtype": "float16"}, {"feature_subset": 1.5},
               {"feature_subset": "half"}, {"min_info_gain": -1.0},
               {"criterion": "mse"}, {"leaf_smoothing": -1.0}):
        with pytest.raises(ValueError):
            T.DecisionTreeClassifier(**kw)


def test_feature_importances_need_a_fitted_tree_ensemble(data):
    X, y = data
    est = T.BaggingClassifier(T.DecisionTreeClassifier(**TREE), device="cpu")
    assert not hasattr(est, "feature_importances_")
    lr = T.BaggingClassifier(T.LogisticRegression(max_iter=1),
                             n_estimators=2, device="cpu").fit(X, y)
    with pytest.raises(AttributeError, match="tree"):
        lr.feature_importances_  # noqa: B018
