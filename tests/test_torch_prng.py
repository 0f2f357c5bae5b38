"""Bitwise parity of the port's key schedule and bootstrap with JAX.

The port (spark_bagging_tpu_torch/ops/prng.py, ops/bootstrap.py)
re-implements threefry-2x32 and the parts of ``jax.random`` the
bootstrap uses, so every replica's row weights, feature draws and
training keys must equal the JAX package's bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spark_bagging_tpu.ops import bootstrap as jboot  # noqa: E402
from spark_bagging_tpu.utils import datasets as jdata  # noqa: E402
from spark_bagging_tpu_torch.ops import bootstrap as tboot  # noqa: E402
from spark_bagging_tpu_torch.ops import prng  # noqa: E402
from spark_bagging_tpu_torch.utils import datasets as tdata  # noqa: E402

SEEDS = [0, 1, 2**31 - 1]
REPLICA_IDS = [0, 1, 3862, 3863, 3864, 70000]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU fits here take one intra-op thread: under xdist each
    worker's default pool takes every core of the host and the workers'
    pools spin against one another (tests/test_torch_stream.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey_data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS + [123456])
def test_key_fold_in_split_uniform_bitwise(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_jkey_data(jk), tk.numpy())
    for data in REPLICA_IDS + [0xB0B5, 0xF17, 2**32 - 1]:
        np.testing.assert_array_equal(
            _jkey_data(jax.random.fold_in(jk, data)),
            prng.fold_in(tk, data).numpy(),
        )
    np.testing.assert_array_equal(
        _jkey_data(jax.random.split(jk, 5)), prng.split(tk, 5).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (1001,), jnp.float32)),
        prng.uniform(tk, 1001).numpy(),
    )


@pytest.mark.parametrize("seed", [2**31, 2**32 + 5, 2**40, -1])
def test_key_keeps_the_low_32_bits_as_jax_does(seed):
    # jax.random.key in its default 32-bit mode keeps seed mod 2**32
    np.testing.assert_array_equal(_jkey_data(jax.random.key(seed)),
                                  prng.key(seed).numpy())


def test_fold_in_batches_over_replica_ids():
    tk = prng.key(7)
    batched = prng.fold_in(tk, torch.tensor(REPLICA_IDS))
    for i, rid in enumerate(REPLICA_IDS):
        assert torch.equal(batched[i], prng.fold_in(tk, rid))


@pytest.mark.parametrize("span", [1, 9, 54, 1000])
def test_randint_bitwise(span):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(
                jax.random.key(seed), (37,), 0, span, jnp.int32
            )),
            prng.randint(prng.key(seed), 37, 0, span).numpy(),
        )


@pytest.mark.parametrize("span", [2**16, 70_000, 2**20, 2**31 - 1])
def test_randint_wide_spans_bitwise(span):
    # spans past 2**16 wrap JAX's uint32 offset arithmetic
    for seed in SEEDS:
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(
                jax.random.key(seed), (257,), 0, span, jnp.int32
            )),
            prng.randint(prng.key(seed), 257, 0, span).numpy(),
        )


def test_subspace_draw_over_70000_features_bitwise():
    # bootstrap_features=True over more than 2**16 features
    ids = torch.tensor(REPLICA_IDS[:3])
    got = tboot.feature_subspaces(prng.key(0), ids, 70_000, 50,
                                  replacement=True).numpy()
    for i, rid in enumerate(REPLICA_IDS[:3]):
        np.testing.assert_array_equal(
            np.asarray(jboot.feature_subspace_one(
                jax.random.key(0), jnp.int32(rid), 70_000, 50,
                replacement=True)),
            got[i],
        )
    assert got.max() >= 2**16  # the draw reaches past the old limit


def test_poisson_cdf_table_equal():
    for lam in (0.25, 0.5, 1.0, 2.0, 32.0):
        np.testing.assert_array_equal(
            jboot._poisson_cdf_table(lam), tboot._poisson_cdf_table(lam)
        )


def test_stream_tags_and_schema_equal():
    for name in ("_FEATURE_STREAM", "_FIT_STREAM", "_ROW_STREAM",
                 "_ONLINE_STREAM", "RNG_SCHEMA", "_MAX_COUNT"):
        assert getattr(jboot, name) == getattr(tboot, name), name


@pytest.mark.parametrize("replacement", [True, False])
@pytest.mark.parametrize("ratio", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("n_rows", [1, 7, 1000, 4097])
@pytest.mark.parametrize("seed", SEEDS)
def test_bootstrap_weights_bitwise(seed, n_rows, ratio, replacement):
    ids = torch.tensor(REPLICA_IDS)
    got = tboot.bootstrap_weights(
        prng.key(seed), ids, n_rows, ratio=ratio, replacement=replacement
    ).numpy()
    # the JAX package's batch form: bootstrap_weights_one vmapped over ids
    want = np.asarray(jboot.bootstrap_weights(
        jax.random.key(seed), jnp.asarray(REPLICA_IDS, jnp.int32), n_rows,
        ratio=ratio, replacement=replacement,
    ))
    np.testing.assert_array_equal(want, got)


def test_bootstrap_rejects_what_is_not_ported():
    # a rate above 32 draws through the rejection sampler now (bitwise:
    # test_rejection_sampler_bitwise); a rate of 0 still raises
    ids = torch.tensor([0])
    w = tboot.bootstrap_weights(prng.key(0), ids, 10, ratio=40.0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(
        jboot.bootstrap_weights(jax.random.key(0), jnp.asarray([0]), 10,
                                ratio=40.0)))
    with pytest.raises(ValueError):
        tboot.bootstrap_weights(prng.key(0), ids, 10, ratio=0.0)


@pytest.mark.parametrize("ratio", [32.5, 50.0, 200.0, 1000.0])
def test_rejection_sampler_bitwise(ratio):
    """lambda > 32: jax.random.poisson's rejection branch, bitwise. Eight
    replicas stop after different numbers of rounds (each loops until
    its own 4,096 rows accept and then freezes) and rows accepted twice
    keep the later value; a last-bit difference in log or lgamma would
    flip a row. At 1000 every count clamps to 255."""
    ids = jnp.arange(8, dtype=jnp.int32)
    want = np.asarray(jax.vmap(lambda r: jboot.bootstrap_weights_one(
        jax.random.key(3), r, 4096, ratio=ratio))(ids))
    got = tboot.bootstrap_weights(prng.key(3), torch.arange(8), 4096,
                                  ratio=ratio).numpy()
    np.testing.assert_array_equal(want, got)
    # the unclamped counts too, where the clamp does not hide them
    if ratio < 200:
        rk = jax.vmap(lambda r: jax.random.fold_in(jax.random.fold_in(
            jax.random.key(3), jboot._ROW_STREAM), r))(ids)
        raw = np.asarray(jax.vmap(
            lambda k: jax.random.poisson(k, ratio, (4096,)))(rk))
        trk = prng.fold_in(prng.fold_in(prng.key(3), tboot._ROW_STREAM),
                           torch.arange(8))
        np.testing.assert_array_equal(
            raw, prng.poisson(trk, ratio, 4096).numpy())


def test_xla_log_and_lgamma_bitwise():
    """The float32 log and lgamma the sampler's accept test reads: XLA's
    CPU code (Cephes log, Lanczos lgamma, fused multiply-adds), bitwise,
    where torch.log differs in about one input in six."""
    x = np.concatenate([
        np.arange(0x3F000000, 0x40000000, 37, dtype=np.uint32).view(
            np.float32),
        np.random.default_rng(0).uniform(1e-6, 1e4, 200_000).astype(
            np.float32)])
    np.testing.assert_array_equal(np.asarray(jax.jit(jnp.log)(x)),
                                  prng.xla_log(torch.from_numpy(x)).numpy())
    k = np.arange(0, 20_000, dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda k: jax.lax.lgamma(k + 1))(k)),
        prng._lgamma_1p(torch.from_numpy(k)).numpy())
    with pytest.raises(ValueError, match="lam >= 10"):
        prng.poisson(prng.key(0), 5.0, 4)


@pytest.mark.parametrize("n", [1, 2, 7, 43, 54, 1000])
def test_permutation_bitwise(n):
    for seed in SEEDS:
        jk, tk = jax.random.key(seed), prng.key(seed)
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(jk, n)),
            prng.permutation(tk, n).numpy(),
        )
        # batched keys: one permutation per key
        keys = prng.fold_in(tk, torch.tensor(REPLICA_IDS))
        batched = prng.permutation(keys, n)
        for i, rid in enumerate(REPLICA_IDS):
            np.testing.assert_array_equal(
                np.asarray(jax.random.permutation(
                    jax.random.fold_in(jk, rid), n)),
                batched[i].numpy(),
            )


def test_permutation_two_rounds_bitwise():
    # JAX's round count ceil(3 ln n / ln(2**32 - 1)) is 2 from ~1.6M
    n = 1_700_000
    np.testing.assert_array_equal(
        np.asarray(jax.random.permutation(jax.random.key(5), n)),
        prng.permutation(prng.key(5), n).numpy(),
    )


@pytest.mark.parametrize("shape", [(1, 54), (4, 43), (16, 13), (3, 5, 7)])
def test_uniform_of_a_shape_bitwise(shape):
    # _level_feat_mask draws an (N, F) uniform per replica key
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.key(seed), 3)
        tk = prng.fold_in(prng.key(seed), 3)
        got = prng.uniform(tk, shape)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(
            np.asarray(jax.random.uniform(jk, shape, jnp.float32)),
            got.numpy(),
        )
    keys = prng.fold_in(prng.key(1), torch.tensor(REPLICA_IDS))
    assert tuple(prng.uniform(keys, shape).shape) == (len(REPLICA_IDS), *shape)


@pytest.mark.parametrize("n_features,n_sub", [(8, 3), (8, 7), (54, 43),
                                              (13, 1), (100, 37)])
def test_feature_subspaces_without_replacement_bitwise(n_features, n_sub):
    ids = torch.tensor(REPLICA_IDS)
    for seed in SEEDS:
        jk = jax.random.key(seed)
        got = tboot.feature_subspaces(prng.key(seed), ids, n_features, n_sub)
        assert got.dtype == torch.int32
        assert tuple(got.shape) == (len(REPLICA_IDS), n_sub)
        want = np.asarray(jboot.feature_subspaces(
            jk, jnp.asarray(REPLICA_IDS, jnp.int32), n_features, n_sub))
        np.testing.assert_array_equal(want, got.numpy())
        for i, rid in enumerate(REPLICA_IDS[:2]):
            np.testing.assert_array_equal(
                np.asarray(jboot.feature_subspace_one(
                    jk, jnp.int32(rid), n_features, n_sub)),
                got[i].numpy(),
            )


@pytest.mark.parametrize("n_sub", [3, 8])
def test_feature_subspaces_bitwise(n_sub):
    ids = torch.tensor(REPLICA_IDS)
    for seed in SEEDS:
        jk = jax.random.key(seed)
        got = tboot.feature_subspaces(
            prng.key(seed), ids, 8, n_sub, replacement=True
        ).numpy()
        ident = tboot.feature_subspaces(prng.key(seed), ids, 8, 8).numpy()
        for i, rid in enumerate(REPLICA_IDS):
            np.testing.assert_array_equal(
                np.asarray(jboot.feature_subspace_one(
                    jk, jnp.int32(rid), 8, n_sub, replacement=True
                )),
                got[i],
            )
            np.testing.assert_array_equal(
                np.asarray(jboot.feature_subspace_one(jk, jnp.int32(rid), 8, 8)),
                ident[i],
            )
        assert got.dtype == np.int32


def test_replica_init_fit_keys_bitwise():
    ids = torch.tensor(REPLICA_IDS)
    init_t, fit_t = tboot.replica_init_fit_keys(prng.key(3), ids)
    for i, rid in enumerate(REPLICA_IDS):
        init_j, fit_j = jboot.replica_init_fit_keys(
            jax.random.key(3), jnp.int32(rid)
        )
        np.testing.assert_array_equal(_jkey_data(init_j), init_t[i].numpy())
        np.testing.assert_array_equal(_jkey_data(fit_j), fit_t[i].numpy())


def test_oob_mask():
    w = torch.tensor([[0.0, 1.0, 2.0, 0.0]])
    assert tboot.oob_mask(w).tolist() == [[True, False, False, True]]


def test_synthetic_covtype_bitwise():
    assert tdata.SYNTHETICS_VERSION == jdata.SYNTHETICS_VERSION
    Xj, yj = jdata.synthetic_covtype(1000)
    Xt, yt = tdata.synthetic_covtype(1000)
    np.testing.assert_array_equal(Xj, Xt)
    np.testing.assert_array_equal(yj, yt)
    assert Xt.shape == (1000, 54) and Xt.dtype == np.float32


def test_regression_synthetics_bitwise():
    assert tdata.SYNTHETICS_VERSION == jdata.SYNTHETICS_VERSION
    for kw in ({}, {"noise": 0.1, "structure_seed": 9}):
        Xj, yj = jdata.make_regression(300, 5, seed=2, **kw)
        Xt, yt = tdata.make_regression(300, 5, seed=2, **kw)
        np.testing.assert_array_equal(Xj, Xt)
        np.testing.assert_array_equal(yj, yt)
    Xj, yj = jdata.synthetic_california(1000)
    Xt, yt = tdata.synthetic_california(1000)
    np.testing.assert_array_equal(Xj, Xt)
    np.testing.assert_array_equal(yj, yt)
    assert Xt.shape == (1000, 8) and yt.dtype == np.float32


def test_split_and_standardize_match_the_benchmark_configs():
    from benchmarks import run_configs

    X, y = tdata.synthetic_california(500)
    np.testing.assert_array_equal(run_configs._standardize(X),
                                  tdata.standardize(X))
    for a, b in zip(run_configs._split(X, y), tdata.train_test_split(X, y)):
        np.testing.assert_array_equal(a, b)


def test_make_classification_bitwise():
    for kw in ({}, {"class_imbalance": True, "axis_features": 2,
                    "axis_gap": 0.5, "structure_seed": 4}):
        Xj, yj = jdata.make_classification(400, 8, 3, seed=5, **kw)
        Xt, yt = tdata.make_classification(400, 8, 3, seed=5, **kw)
        np.testing.assert_array_equal(Xj, Xt)
        np.testing.assert_array_equal(yj, yt)
