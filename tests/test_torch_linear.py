"""The port's LinearRegression against the JAX package's.

Both solve the same float32 weighted ridge normal equations with an LU
solve of partial pivoting, so beta differs only by the float32 rounding
of the Gram products and the solve, summed in other orders: on these
standardized inputs (d <= 8, a few hundred rows) within BETA_TOL of the
largest |beta|. The loss (a weighted mean of squared residuals) within
LOSS_RTOL relative.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402

BETA_TOL = 1e-5
LOSS_RTOL = 1e-5


def _data(n=300, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (X @ beta + 1.5 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _fit_both(X, y, W, **kw):
    """(JAX params and aux vmapped over W's rows, the port's batched)."""
    jl = J.LinearRegression(**kw)
    jp, jaux = jax.vmap(lambda w: jl.fit(
        jl.init_params(None, X.shape[1], 1), jnp.asarray(X), jnp.asarray(y),
        w, None))(jnp.asarray(W))
    tl = T.LinearRegression(**kw)
    keys = torch.zeros((W.shape[0], 2), dtype=torch.int64)
    tp, taux = tl.fit(tl.init_params(keys, X.shape[1], 1), torch.from_numpy(X),
                      torch.from_numpy(y), torch.from_numpy(W), keys)
    return jp, jaux, tp, taux


def assert_beta_close(got, want, tol=BETA_TOL):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max |d beta| is {err:.3g} of max |beta| (> {tol})"


@pytest.mark.parametrize("l2", [1e-4, 0.0, 0.5])
def test_beta_matches_jax_on_poisson_weights(l2):
    X, y = _data()
    W = np.random.default_rng(1).poisson(1.0, (6, len(y))).astype(np.float32)
    jp, jaux, tp, taux = _fit_both(X, y, W, l2=l2)
    assert tuple(tp["beta"].shape) == (6, 7)
    assert_beta_close(tp["beta"].numpy(), np.asarray(jp["beta"]))
    np.testing.assert_allclose(taux["loss"].numpy(), np.asarray(jaux["loss"]),
                               rtol=LOSS_RTOL)
    assert tuple(taux["loss_curve"].shape) == (6, 1)


@pytest.mark.parametrize("l2", [1e-4, 0.0])
def test_all_zero_draw_gives_beta_zero(l2):
    X, y = _data()
    W = np.ones((3, len(y)), np.float32)
    W[1] = 0.0
    jp, _, tp, taux = _fit_both(X, y, W, l2=l2)
    assert (tp["beta"][1] == 0).all()
    assert torch.isfinite(tp["beta"]).all() and torch.isfinite(taux["loss"]).all()
    np.testing.assert_array_equal(np.asarray(jp["beta"])[1], 0.0)
    assert_beta_close(tp["beta"].numpy()[[0, 2]], np.asarray(jp["beta"])[[0, 2]])


def test_one_surviving_row_gives_a_finite_beta():
    # a rank-one Gram: the l2 * sum(w) penalty keeps it nonsingular, and
    # LU with pivoting solves it finitely where Cholesky may not
    X, y = _data()
    W = np.zeros((2, len(y)), np.float32)
    W[0, 17] = 1.0
    W[1, 5] = 3.0
    jp, _, tp, _ = _fit_both(X, y, W, l2=1e-4)
    assert torch.isfinite(tp["beta"]).all()
    assert np.isfinite(np.asarray(jp["beta"])).all()
    # the Gram's condition number, ~|x|^2 / l2 ~ 1e4, amplifies float32
    # rounding (~6e-8) to ~1e-3 of beta: held at 2e-3 here
    assert_beta_close(tp["beta"].numpy(), np.asarray(jp["beta"]), tol=2e-3)
    # both fit the surviving row's target
    for r, i in ((0, 17), (1, 5)):
        fit = X[i] @ tp["beta"][r, :-1].numpy() + tp["beta"][r, -1].item()
        assert abs(fit - y[i]) <= 1e-3 * max(1.0, abs(y[i]))


def test_gathered_subspace_x_matches_jax():
    # a feature subspace hands each replica its gathered (n, k) columns
    X, y = _data(d=8)
    cols = np.array([[0, 3, 5], [7, 1, 2]])
    W = np.random.default_rng(2).poisson(1.0, (2, len(y))).astype(np.float32)
    jl, tl = J.LinearRegression(l2=1e-3), T.LinearRegression(l2=1e-3)
    Xg = np.stack([X[:, c] for c in cols])
    keys = torch.zeros((2, 2), dtype=torch.int64)
    tp, _ = tl.fit(tl.init_params(keys, 3, 1), torch.from_numpy(Xg),
                   torch.from_numpy(y), torch.from_numpy(W), keys)
    for r in range(2):
        jp, _ = jl.fit(jl.init_params(None, 3, 1), jnp.asarray(Xg[r]),
                       jnp.asarray(y), jnp.asarray(W[r]), None)
        assert_beta_close(tp["beta"][r].numpy(), np.asarray(jp["beta"]))
    pred = tl.predict_scores(tp, torch.from_numpy(Xg))
    want = np.einsum("rnk,rk->rn", Xg, tp["beta"][:, :-1].numpy()) \
        + tp["beta"][:, -1:].numpy()
    np.testing.assert_allclose(pred.numpy(), want, rtol=1e-5, atol=1e-5)


def test_models_and_losses_match_jax():
    X, y = _data()
    rng = np.random.default_rng(4)
    beta = rng.standard_normal((3, 7)).astype(np.float32)
    jl, tl = J.LinearRegression(l2=0.3), T.LinearRegression(l2=0.3)
    tp = {"beta": torch.from_numpy(beta)}
    Xt = torch.from_numpy(X)
    for r in range(3):
        jp = {"beta": jnp.asarray(beta[r])}
        np.testing.assert_allclose(
            tl.predict_scores(tp, Xt)[r].numpy(),
            np.asarray(jl.predict_scores(jp, jnp.asarray(X))), rtol=1e-5,
            atol=1e-5)
        np.testing.assert_allclose(
            tl.row_loss(tp, Xt, torch.from_numpy(y))[r].numpy(),
            np.asarray(jl.row_loss(jp, jnp.asarray(X), jnp.asarray(y))),
            rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tl.penalty(tp)[r]),
                                   float(jl.penalty(jp)), rtol=1e-6)
    assert tl.linear_beta(tp) is tp["beta"]
    for args in ((16_512, 8, 1), (100, 3, 1)):
        assert tl.flops_per_fit(*args) == jl.flops_per_fit(*args)
        assert tl.fit_workset_bytes(*args) == jl.fit_workset_bytes(*args)


def test_precision_names_are_checked():
    X, y = _data(n=20, d=2)
    tl = T.LinearRegression(precision="bogus")
    keys = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="precision"):
        tl.fit(tl.init_params(keys, 2, 1), torch.from_numpy(X),
               torch.from_numpy(y), torch.ones((1, 20)), keys)


def test_memory_model_prices_linear_regression():
    from spark_bagging_tpu_torch.utils.memory import (
        BOOTSTRAP_BYTES_PER_ROW,
        auto_chunk_size,
    )

    tl = T.LinearRegression()
    cpu = torch.device("cpu")
    n, d = 16_512, 8
    per = tl.fit_workset_bytes(n, d, 1) + BOOTSTRAP_BYTES_PER_ROW * n
    assert per == 4 * n * (3 * 9 + 2) + 48.0 * n
    # config 2's 100 replicas fit one chunk; a tight budget splits them
    assert auto_chunk_size(tl, n, d, 1, 100, cpu, n_features=d) is None
    budget = 10 * per
    assert auto_chunk_size(tl, n, d, 1, 100, cpu, budget_bytes=budget,
                           n_features=d) == 10
    # a subspace adds the gathered copy of X
    assert auto_chunk_size(tl, n, 4, 1, 100, cpu, budget_bytes=budget,
                           n_features=d) == int(
        budget // (tl.fit_workset_bytes(n, 4, 1) + 48.0 * n + 4.0 * n * 4))
