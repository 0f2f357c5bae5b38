"""The port's MLP learners, its normal draws and its Adam against JAX.

Both packages get the same numpy data and keys (threefry: bitwise equal
keys, uniforms, bootstrap weights and minibatch draws).

Tolerances, found on this CPU (jax 0.9.0, torch 2.13):
- ``prng.normal``: at most NORMAL_ULPS (3) ulps from
  ``jax.random.normal`` (found: 3 over 1.8M draws). The uniforms are
  bitwise equal and both sides evaluate XLA's ``erf_inv`` polynomial;
  ``log1p`` differs in its last bits (``torch.erfinv``, another
  approximation, differs by up to 86 ulps in the tails).
- the port's Adam: bitwise equal to ``optax.adam`` on a fixed gradient
  sequence (50 steps, gradients from 1e-6 to 10).
- in-memory MLP fits (30 Adam steps, full batch and minibatches, 240
  rows): parameters, the final loss and ``predict_proba`` within
  MLP_TOL (1e-5; found at most 4.2e-7). The forward products sum in
  another order (one GEMM for every replica here, one per replica
  there) and Adam's normalized steps carry the difference forward,
  growing with the step count, so the bound leaves a factor of ~20.
- config 4's learner at the shapes chip_smoke's ``mlp_device_check``
  holds the card to (16 replicas, 50 steps of 1,024 rows of 20,000):
  ``predict_proba`` within MLP_TOL (found 1.3e-6), parameters within
  LONG_PARAM_TOL (2e-4; found up to 6.9e-5 over seeds 0-3, the same
  with one thread and with eight: the port's CPU first layer sums its
  features in one fixed order, models/mlp.py). That is
  past 1e-4 because Adam divides each element's first moment by the
  root of its second: an element whose gradient stays near zero turns
  a last-bit difference into a step difference of up to ``lr`` (0.01),
  and over 50 steps a few such elements drift apart by ~1e-4 while the
  outputs do not.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

import spark_bagging_tpu as J  # noqa: E402
import spark_bagging_tpu_torch as T  # noqa: E402
from spark_bagging_tpu.models import mlp as jmlp  # noqa: E402
from spark_bagging_tpu_torch.models import mlp as tmlp  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.optim import Adam  # noqa: E402
from spark_bagging_tpu_torch.utils.datasets import (  # noqa: E402
    make_classification,
    make_regression,
    synthetic_higgs,
)

NORMAL_ULPS = 3
MLP_TOL = 1e-5
LONG_PARAM_TOL = 2e-4
# torch's default CPU thread count, read before the module fixture below
# sets one thread: the thread-count tests use it where they mean "the
# default"
DEFAULT_THREADS = torch.get_num_threads()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_stream.py explains; the
    thread-count tests set their own counts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed,shape", [(0, (28, 32)), (1, (7,)),
                                        (2, (300_000,)), (2**31 + 5, (3, 4))])
def test_normal_within_ulps_of_jax(seed, shape):
    want = jax.random.normal(jax.random.key(seed), shape, jnp.float32)
    got = prng.normal(prng.key(seed), shape)
    assert got.shape == shape and got.dtype == torch.float32
    assert _ulps(want, got.numpy()) <= NORMAL_ULPS


def test_normal_batches_over_keys():
    keys = prng.fold_in(prng.key(3), torch.arange(5))
    got = prng.normal(keys, (4, 3))
    want = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(3), i), (4, 3))) for i in range(5)])
    assert got.shape == (5, 4, 3)
    assert _ulps(want, got.numpy()) <= NORMAL_ULPS


def test_adam_bitwise_equal_to_optax():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 5, 4)).astype(np.float32),
          "b": rng.standard_normal((3, 4)).astype(np.float32)}
    opt = optax.adam(0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    adam = Adam(tp, 0.01)
    for _ in range(50):
        g = {k: (rng.standard_normal(v.shape)
                 * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
             for k, v in p0.items()}
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in p0:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert adam.count == 50


def _task(task):
    if task == "classification":
        X, y = make_classification(240, 5, 3, seed=0)
        return X, y, J.BaggingClassifier, T.BaggingClassifier, \
            jmlp.MLPClassifier, T.MLPClassifier
    X, y = make_regression(240, 5, seed=0)
    return X, y, J.BaggingRegressor, T.BaggingRegressor, \
        jmlp.MLPRegressor, T.MLPRegressor


@pytest.mark.parametrize("task,activation,batch_size", [
    ("classification", "relu", None),
    ("classification", "tanh", 32),
    ("classification", "gelu", None),
    ("classification", "relu", 32),
    ("regression", "tanh", None),
    ("regression", "gelu", 32),
])
def test_in_memory_fit_matches_jax(task, activation, batch_size):
    X, y, JE, TE, JL, TL = _task(task)
    kw = dict(hidden=8, max_iter=30, batch_size=batch_size, lr=0.02,
              activation=activation)
    est = dict(n_estimators=4, max_features=0.8, seed=2)
    jf = JE(JL(**kw), **est).fit(X, y)
    tf = TE(TL(**kw), device="cpu", **est).fit(X, y)
    np.testing.assert_array_equal(tf.subspaces_.numpy(),
                                  np.asarray(jf.subspaces_))
    for k, v in tf.ensemble_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jf.ensemble_[k]),
                                   atol=MLP_TOL, rtol=0, err_msg=k)
    assert abs(tf.fit_report_["loss_mean"]
               - jf.fit_report_["loss_mean"]) <= MLP_TOL
    if task == "classification":
        np.testing.assert_allclose(tf.predict_proba(X), jf.predict_proba(X),
                                   atol=MLP_TOL, rtol=0)
    else:
        np.testing.assert_allclose(tf.predict(X), jf.predict(X),
                                   atol=MLP_TOL, rtol=0)


def test_config4_learner_fit_at_the_card_checks_shapes_matches_jax():
    jf, tf = _config4_fits(0, 1)
    for k, v in tf.ensemble_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jf.ensemble_[k]),
                                   atol=LONG_PARAM_TOL, rtol=0, err_msg=k)
    Xte, _ = synthetic_higgs(10_000, seed=999_001, structure_seed=11)
    np.testing.assert_allclose(tf.predict_proba(Xte), jf.predict_proba(Xte),
                               atol=MLP_TOL, rtol=0)


CONFIG4_MLP = dict(hidden=32, lr=0.01, max_iter=50, batch_size=1024)
_JAX_CONFIG4_FITS: dict = {}
_PORT_CONFIG4_FITS: dict = {}


def _config4_port_fit(seed, threads):
    """The port's config-4 learner fit (the shapes of chip_smoke's
    ``mlp_device_check``) with ``seed`` on ``threads`` CPU threads
    (None: torch's default, DEFAULT_THREADS), made once a key."""
    if (seed, threads) not in _PORT_CONFIG4_FITS:
        X, y = synthetic_higgs(20_000, seed=5, structure_seed=11)
        before = torch.get_num_threads()
        try:
            torch.set_num_threads(DEFAULT_THREADS if threads is None
                                  else threads)
            _PORT_CONFIG4_FITS[seed, threads] = T.BaggingClassifier(
                T.MLPClassifier(**CONFIG4_MLP), n_estimators=16, seed=seed,
                device="cpu").fit(X, y)
        finally:
            torch.set_num_threads(before)
    return _PORT_CONFIG4_FITS[seed, threads]


def _config4_fits(seed, threads):
    """JAX's and the port's config-4 learner fits with ``seed``, the
    port's on ``threads`` CPU threads; each is made once."""
    if seed not in _JAX_CONFIG4_FITS:
        X, y = synthetic_higgs(20_000, seed=5, structure_seed=11)
        _JAX_CONFIG4_FITS[seed] = J.BaggingClassifier(
            jmlp.MLPClassifier(**CONFIG4_MLP), n_estimators=16,
            seed=seed).fit(X, y)
    return _JAX_CONFIG4_FITS[seed], _config4_port_fit(seed, threads)


# The (seed, None) cases fit on torch's default thread count (8 on an
# 8-core host) and are in `slow`: in tier-1 each of the 6 xdist workers
# would run 8 threads, and each case took 36-54 s there against ~5 s
# alone. Tier-1 keeps the one-thread cases and
# test_config4_learner_fit_is_bitwise_the_same_on_the_default_threads,
# which holds the default-thread fit bitwise to the one-thread fit.
@pytest.mark.parametrize("seed,threads", [
    pytest.param(1, None, marks=pytest.mark.slow),
    pytest.param(2, None, marks=pytest.mark.slow),
    pytest.param(3, None, marks=pytest.mark.slow),
    (0, 1), (1, 1), (2, 1), (3, 1)])
def test_config4_learner_parity_holds_for_each_seed_and_thread_count(
        seed, threads):
    # the test above at seeds 0-3, with torch's default CPU threads and
    # with one: the port's CPU fit is the same either way (a ReLU unit's
    # activity is decided by a fixed-order sum, models/mlp.py)
    jf, tf = _config4_fits(seed, threads)
    for k, v in tf.ensemble_.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jf.ensemble_[k]),
                                   atol=LONG_PARAM_TOL, rtol=0, err_msg=k)
    Xte, _ = synthetic_higgs(10_000, seed=999_001, structure_seed=11)
    np.testing.assert_allclose(tf.predict_proba(Xte), jf.predict_proba(Xte),
                               atol=MLP_TOL, rtol=0)


def test_config4_learner_fit_is_bitwise_the_same_on_the_default_threads():
    """The config-4 learner's CPU fit on torch's default thread count is
    bit for bit its one-thread fit (which the case above holds to JAX):
    the first layer sums in a fixed order (models/mlp.py), and the rest
    does not split its sums by thread."""
    one, default = _config4_port_fit(1, 1), _config4_port_fit(1, None)
    for k, v in one.ensemble_.items():
        assert torch.equal(default.ensemble_[k], v), k


@pytest.mark.parametrize("F", [28, 27])
def test_cpu_first_layer_is_the_same_on_any_thread_count(F):
    X = np.random.default_rng(F).standard_normal((4, 1024, F)).astype(
        np.float32)
    W1 = tmlp.MLPClassifier(hidden=32).init_params(
        prng.split(prng.key(0), 4), F, 2)["W1"]
    Xt = torch.from_numpy(X)
    before = torch.get_num_threads()
    try:
        outs = []
        for threads in (1, max(2, DEFAULT_THREADS)):
            torch.set_num_threads(threads)
            outs.append(tmlp._FixedOrderFirstLayer.apply(Xt, W1))
    finally:
        torch.set_num_threads(before)
    assert torch.equal(outs[0], outs[1])
    # two float32 multiply-add chains, even and odd features, then added
    x, w = X.astype(np.float64), W1.numpy().astype(np.float64)
    lanes = [np.zeros((4, 1024, 32), np.float32) for _ in range(2)]
    for k in range(F):
        lanes[k % 2] = (x[..., k, None] * w[:, None, k]
                        + lanes[k % 2]).astype(np.float32)
    np.testing.assert_array_equal(outs[0].numpy(), lanes[0] + lanes[1])
    if F == 28:  # config 4's width: XLA's CPU dot sums the same way
        want = jax.vmap(jnp.matmul)(jnp.asarray(X), jnp.asarray(W1.numpy()))
        np.testing.assert_array_equal(outs[0].numpy(), np.asarray(want))


def test_init_params_within_ulps_of_jax():
    jl, tl = jmlp.MLPClassifier(hidden=16), T.MLPClassifier(hidden=16)
    key = jax.random.key(7)
    want = jax.vmap(lambda r: jl.init_params(
        jax.random.fold_in(key, r), 9, 4))(jnp.arange(3))
    got = tl.init_params(prng.fold_in(prng.key(7), torch.arange(3)), 9, 4)
    for k in ("W1", "b1", "W2", "b2"):
        assert got[k].shape == want[k].shape
        assert _ulps(want[k], got[k].numpy()) <= NORMAL_ULPS, k
    reg = T.MLPRegressor(hidden=4).init_params(prng.key(0)[None], 3, 5)
    assert reg["W2"].shape == (1, 4, 1)


@pytest.mark.parametrize("cls", ["MLPClassifier", "MLPRegressor"])
@pytest.mark.parametrize("batch_size", [None, 64, 10_000])
def test_cost_models_equal_jax(cls, batch_size):
    jl = getattr(jmlp, cls)(hidden=32, max_iter=50, batch_size=batch_size)
    tl = getattr(tmlp, cls)(hidden=32, max_iter=50, batch_size=batch_size)
    for n, d, c in ((20_000, 28, 2), (500, 7, 3)):
        assert tl.flops_per_fit(n, d, c) == jl.flops_per_fit(n, d, c)
        assert tl.sgd_step_flops(n, d, c) == jl.sgd_step_flops(n, d, c)
        assert tl.fit_workset_bytes(n, d, c) == jl.fit_workset_bytes(n, d, c)
    assert tl.streamable and jl.streamable


@pytest.mark.parametrize("kw", [dict(max_iter=0), dict(hidden=0),
                                dict(batch_size=0),
                                dict(activation="swish")])
def test_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jmlp.MLPClassifier(**kw)
    with pytest.raises(ValueError):
        T.MLPClassifier(**kw)


def test_unknown_precision_name_raises():
    with pytest.raises(ValueError, match="precision"):
        T.MLPRegressor(precision="bf16")
