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
    ids = torch.tensor([0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tboot.bootstrap_weights(prng.key(0), ids, 10, ratio=40.0)
    with pytest.raises(ValueError):
        tboot.bootstrap_weights(prng.key(0), ids, 10, ratio=0.0)


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


def test_make_classification_bitwise():
    for kw in ({}, {"class_imbalance": True, "axis_features": 2,
                    "axis_gap": 0.5, "structure_seed": 4}):
        Xj, yj = jdata.make_classification(400, 8, 3, seed=5, **kw)
        Xt, yt = tdata.make_classification(400, 8, 3, seed=5, **kw)
        np.testing.assert_array_equal(Xj, Xt)
        np.testing.assert_array_equal(yj, yt)
