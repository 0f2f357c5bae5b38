"""Newton logistic regression: the port against the JAX package.

Both packages fit the same replicas (numpy-made data and bootstrap
counts) from the same start; every replica's weights must agree.

Tolerance: max |W_port - W_jax| <= 1e-4 x max |W_jax|. Both solve in
float32, but they sum the gradient and Hessian in other orders and
factor with other Cholesky codes; one damped Newton step amplifies
those ~1e-7 relative differences by the Hessian's conditioning (up to
~1/damping = 1e3), and later steps contract them again.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spark_bagging_tpu.models.logistic import (  # noqa: E402
    LogisticRegression as JaxLR,
)
from spark_bagging_tpu_torch.models.logistic import (  # noqa: E402
    LogisticRegression,
    _assemble_hessian,
)
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import make_classification  # noqa: E402

W_TOL = 1e-4
N_REPLICAS = 5


def assert_w_close(got, want, tol=W_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max |dW| is {err:.3g} of max |W| (> {tol})"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU fits here take one intra-op thread: under xdist each
    worker's default pool takes every core of the host and the workers'
    pools spin against one another (tests/test_torch_stream.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=300, d=6, C=4):
    X, y = make_classification(n, d, C, seed=1)
    w = np.random.default_rng(2).poisson(1.0, (N_REPLICAS, n)).astype(
        np.float32
    )
    return X, y, w


def _fit_both(impl, init, max_iter, row_tile=None):
    X, y, w = _data()
    C = 4
    kw = dict(max_iter=max_iter, hessian_impl=impl, init=init)
    jl = JaxLR(**kw)
    tl = LogisticRegression(**kw, row_tile=row_tile)
    jkey, tkey = jax.random.key(0), prng.key(0)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()
    if init == "pooled":
        W0j = jl.pooled_init(jkey, None, jnp.asarray(X), jnp.asarray(y), C)
        W0t = tl.pooled_init(tkey, None, Xt, yt, C)
        assert_w_close(W0t.numpy(), W0j)
    else:
        W0j = jnp.zeros((X.shape[1] + 1, C), jnp.float32)
        W0t = torch.zeros((X.shape[1] + 1, C))
    # jitted: run eagerly, every op of the Newton loop dispatches alone
    want = jax.jit(jax.vmap(
        lambda wr: jl.fit({"W": W0j}, jnp.asarray(X), jnp.asarray(y), wr,
                          jkey)[0]["W"]
    ))(jnp.asarray(w))
    keys = prng.split(tkey, N_REPLICAS)
    params0 = tl.initial_params(keys, X.shape[1], C, W0t)
    got, aux = tl.fit(params0, Xt, yt, torch.from_numpy(w), keys)
    return got["W"].numpy(), np.asarray(want), aux


@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("init", ["zeros", "pooled"])
@pytest.mark.parametrize("impl", ["blocked", "pallas"])
def test_newton_weights_match_jax(impl, init, max_iter):
    got, want, aux = _fit_both(impl, init, max_iter)
    assert got.shape == (N_REPLICAS, 7, 4)
    assert_w_close(got, want)
    assert aux["loss"].shape == (N_REPLICAS,)
    assert aux["loss_curve"].shape == (N_REPLICAS, max_iter)
    assert torch.isfinite(aux["loss"]).all()


def test_row_tiles_change_only_summation_order():
    got, want, _ = _fit_both("pallas", "zeros", 2, row_tile=64)
    assert_w_close(got, want)


def test_kernel_and_blocked_hessians_agree():
    X, y, w = _data()
    tl = LogisticRegression()
    Xb = torch.cat([torch.from_numpy(X), torch.ones(X.shape[0], 1)], 1)
    W = 0.1 * torch.randn((N_REPLICAS, Xb.shape[1], 4),
                          generator=torch.Generator().manual_seed(0))
    yt = torch.from_numpy(y).long()
    wt = torch.from_numpy(w)
    out = {impl: tl._newton_stats(W, Xb, yt, wt, 4, impl)
           for impl in ("blocked", "pallas")}
    for a, b in zip(out["blocked"], out["pallas"]):
        assert_w_close(b, a, tol=1e-6)
    H = out["pallas"][2]
    torch.testing.assert_close(H, H.transpose(-1, -2), rtol=0, atol=0)


def test_assemble_hessian_layout():
    C, d = 3, 2
    grams = torch.arange(6.0).reshape(1, 6, 1, 1).expand(1, 6, d, d)
    H = _assemble_hessian(grams.contiguous(), C)[0]
    # pairs (0,0)=0 (0,1)=1 (0,2)=2 (1,1)=3 (1,2)=4 (2,2)=5, mirrored
    want = torch.tensor([[0, 1, 2], [1, 3, 4], [2, 4, 5]], dtype=torch.float32)
    torch.testing.assert_close(H[::d, ::d], want)


def test_auto_resolves_as_jax_and_unported_impls_raise():
    for C in (2, 7, 8, 9, 12):
        assert (LogisticRegression()._resolved_hessian(C)
                == JaxLR()._resolved_hessian(C))
    X, y, w = _data()
    Xt, yt, wt = torch.from_numpy(X), torch.from_numpy(y).long(), torch.from_numpy(w)
    keys = prng.split(prng.key(0), N_REPLICAS)
    # the wide Hessians fit (their parity with JAX: the tests below)
    for impl in ("fused", "packed"):
        lr = LogisticRegression(hessian_impl=impl, max_iter=2)
        params, aux = lr.fit(lr.init_params(keys, 6, 4), Xt, yt, wt, keys)
        assert torch.isfinite(params["W"]).all()
        assert aux["loss_curve"].shape == (N_REPLICAS, 2)
    # the Adam solver is ported (its parity with JAX:
    # tests/test_torch_zoo_clf.py); an unknown solver raises
    lr = LogisticRegression(solver="adam", max_iter=3)
    params, aux = lr.fit(lr.init_params(keys, 6, 4), Xt, yt, wt, keys)
    assert torch.isfinite(params["W"]).all()
    assert aux["loss_curve"].shape == (N_REPLICAS, 3)
    lr = LogisticRegression(solver="lbfgs")
    with pytest.raises(ValueError, match="solver"):
        lr.fit(lr.init_params(keys, 6, 4), Xt, yt, wt, keys)
    with pytest.raises(ValueError):
        LogisticRegression(hessian_impl="dense")
    with pytest.raises(ValueError):
        lr = LogisticRegression(precision="fastest")
        lr.fit(lr.init_params(keys, 6, 4), Xt, yt, wt, keys)


def test_cost_models_match_jax():
    for impl in ("blocked", "pallas", "fused", "packed", "auto"):
        for shape in ((581_012, 54, 7), (400, 8, 3), (50_000, 20, 10)):
            assert (LogisticRegression(hessian_impl=impl).flops_per_fit(*shape)
                    == JaxLR(hessian_impl=impl).flops_per_fit(*shape))
            assert LogisticRegression(hessian_impl=impl).fit_workset_bytes(
                *shape) > 0
    # the wide operands are priced: (rows, C·d) twice for fused, (rows,
    # P·d) for packed, beyond the blocked path's (rows, d) scaled copy
    n, d, C = 50_000, 20, 10
    P = C * (C + 1) // 2
    ws = {impl: LogisticRegression(hessian_impl=impl).fit_workset_bytes(
        n, d, C) for impl in ("blocked", "fused", "packed")}
    assert ws["fused"] - ws["blocked"] == 4.0 * n * (2 * C - 1) * (d + 1)
    assert ws["packed"] - ws["blocked"] == 4.0 * n * (P - 1) * (d + 1)
    assert LogisticRegression().fit_workset_bytes(n, d, C) == ws["fused"]


def _ten_class_data(n=400, d=6):
    X, y = make_classification(n, d, 10, seed=4)
    w = np.random.default_rng(5).poisson(1.0, (N_REPLICAS, n)).astype(
        np.float32)
    return X, y, w


@pytest.mark.parametrize("impl", ["fused", "packed", "auto"])
@pytest.mark.parametrize("row_tile", [None, 128])
def test_wide_hessians_match_jax_at_ten_classes(impl, row_tile):
    X, y, w = _ten_class_data()
    C = 10
    kw = dict(max_iter=3, hessian_impl=impl, init="zeros")
    jl, tl = JaxLR(**kw), LogisticRegression(**kw, row_tile=row_tile)
    assert tl._resolved_hessian(C) == jl._resolved_hessian(C)
    W0j = jnp.zeros((X.shape[1] + 1, C), jnp.float32)
    want = jax.vmap(
        lambda wr: jl.fit({"W": W0j}, jnp.asarray(X), jnp.asarray(y), wr,
                          jax.random.key(0))[0]["W"]
    )(jnp.asarray(w))
    keys = prng.split(prng.key(0), N_REPLICAS)
    got, aux = tl.fit(tl.init_params(keys, X.shape[1], C),
                      torch.from_numpy(X), torch.from_numpy(y).long(),
                      torch.from_numpy(w), keys)
    assert_w_close(got["W"].numpy(), np.asarray(want))
    assert aux["loss_curve"].shape == (N_REPLICAS, 3)


def test_wide_hessians_equal_the_blocked_one():
    X, y, w = _ten_class_data()
    tl = LogisticRegression()
    Xb = torch.cat([torch.from_numpy(X), torch.ones(X.shape[0], 1)], 1)
    W = 0.1 * torch.randn((N_REPLICAS, Xb.shape[1], 10),
                          generator=torch.Generator().manual_seed(0))
    yt, wt = torch.from_numpy(y).long(), torch.from_numpy(w)
    ref = tl._newton_stats(W, Xb, yt, wt, 10, "blocked")
    for impl in ("fused", "packed"):
        out = tl._newton_stats(W, Xb, yt, wt, 10, impl)
        for a, b in zip(ref, out):
            assert_w_close(b, a, tol=1e-6)
    # a per-replica X (a gathered subspace) takes the same path
    Xr = Xb.expand(N_REPLICAS, *Xb.shape)
    out = tl._newton_stats(W, Xr, yt, wt, 10, "fused")
    assert_w_close(out[2], ref[2], tol=1e-6)


def test_default_bagging_classifier_fits_ten_classes_like_jax():
    # LogisticRegression() resolves "auto" to "fused" above 8 classes
    import spark_bagging_tpu as J
    import spark_bagging_tpu_torch as T

    X, y, _ = _ten_class_data(600)
    jc = J.BaggingClassifier(n_estimators=6, seed=0).fit(X, y)
    tc = T.BaggingClassifier(n_estimators=6, seed=0, device="cpu").fit(X, y)
    assert tc.base_learner_._resolved_hessian(10) == "fused"
    assert_w_close(tc.ensemble_["W"].numpy(), np.asarray(jc.ensemble_["W"]))
    np.testing.assert_allclose(tc.predict_proba(X), np.asarray(
        jc.predict_proba(X)), atol=1e-5, rtol=0)
    assert abs(tc.score(X, y) - jc.score(X, y)) <= 1e-5
