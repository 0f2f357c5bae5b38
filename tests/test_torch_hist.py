"""The port's split-search histogram (ops/hist.py) against the JAX
package's Pallas kernel, run in interpret mode as tests/test_hist.py
runs it.

On CPU tensors ``binned_left_stats`` computes its plain version, the
dense indicator contraction. Tolerances:
- integer statistics (Poisson counts times one-hot classes, or Poisson
  counts alone): bitwise, in both ``hist_dtype`` modes. Every partial
  sum is an integer below 2**24, exact in any order, and bf16 holds
  integers up to 256 exactly;
- float statistics: both sides sum the same float32 terms in other
  orders, so each entry agrees within 1e-5 of its absolute-sum scale
  ``sum_i |S[i, k]|`` over the entry's rows (float32 rounding of a few
  hundred terms is ~1e-6 of that scale). The port's ``"bfloat16"``
  mode rounds S first, so it is held to the JAX kernel on S rounded the
  same way.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spark_bagging_tpu.ops.hist import binned_left_stats as jax_hist  # noqa: E402
from spark_bagging_tpu_torch.ops import hist  # noqa: E402

FLOAT_TOL = 1e-5


def _inputs(seed, n, F, B, N, K, R, *, shared_x, shared_edges, stats):
    """X with NaN rows and entries equal to an edge; ascending edges
    ending in +inf; nodes; statistics of the given kind."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F) if shared_x else (R, n, F)).astype(np.float32)
    e = np.sort(rng.standard_normal(
        (F, B - 1) if shared_edges else (R, F, B - 1)), axis=-1)
    edges = np.concatenate([e, np.full(e.shape[:-1] + (1,), np.inf)],
                           axis=-1).astype(np.float32)
    Xv = X.reshape(-1, n, F)
    Ev = edges.reshape(-1, F, B)
    for r in range(Xv.shape[0]):
        rows = rng.integers(0, n, 10)
        f = rng.integers(0, F, 10)
        Xv[r, rows, f] = Ev[r % Ev.shape[0], f, rng.integers(0, B - 1, 10)]
        Xv[r, rng.integers(0, n, 3)] = np.nan  # NaN rows
        Xv[r, rng.integers(0, n, 5), rng.integers(0, F, 5)] = np.nan
    node = rng.integers(0, N, (R, n)).astype(np.int32)
    w = rng.poisson(1.0, (R, n)).astype(np.float32)
    if stats == "onehot":
        S = w[..., None] * np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    elif stats == "poisson":
        S = rng.poisson(2.0, (R, n, K)).astype(np.float32)
    else:  # float moments of a regression target
        yv = rng.standard_normal(n).astype(np.float32)
        S = np.stack([w, w * yv, w * yv * yv], axis=-1)[..., :K]
    return X, edges, node, S.astype(np.float32)


def _jax_ref(X, edges, node, S, N):
    """The JAX kernel, replica by replica."""
    R = S.shape[0]
    return np.stack([np.asarray(jax_hist(
        jnp.asarray(X if X.ndim == 2 else X[r]),
        jnp.asarray(edges if edges.ndim == 2 else edges[r]),
        jnp.asarray(node[r]), jnp.asarray(S[r]), n_nodes=N, interpret=True,
    )) for r in range(R)])


def _port(X, edges, node, S, N, mode):
    return hist.binned_left_stats(
        torch.from_numpy(X), torch.from_numpy(edges),
        torch.from_numpy(node), torch.from_numpy(S), n_nodes=N,
        hist_dtype=mode,
    ).numpy()


def _scale(X, edges, node, S, N):
    """Each entry's absolute-sum scale: the function on |S|."""
    return _port(X, edges, node, np.abs(S), N, "float32")


CASES = [  # n, F, B, N, K, R, shared_x, shared_edges
    (700, 13, 8, 4, 3, 2, True, True),
    (512, 8, 16, 1, 2, 3, False, False),
    (130, 3, 4, 8, 7, 2, True, False),
    (900, 16, 16, 8, 5, 1, False, True),
]


@pytest.mark.parametrize("stats", ["onehot", "poisson"])
@pytest.mark.parametrize("case", CASES)
def test_integer_stats_bitwise_equal_to_jax(case, stats):
    n, F, B, N, K, R, shared_x, shared_edges = case
    X, edges, node, S = _inputs(n + F, n, F, B, N, K, R, shared_x=shared_x,
                                shared_edges=shared_edges, stats=stats)
    want = _jax_ref(X, edges, node, S, N)
    for mode in ("float32", "bfloat16"):
        got = _port(X, edges, node, S, N, mode)
        assert got.shape == (R, F, B, N, K)
        np.testing.assert_array_equal(got, want, err_msg=mode)


@pytest.mark.parametrize("case", CASES[:2])
def test_float_stats_within_tolerance_of_jax(case):
    n, F, B, N, _, R, shared_x, shared_edges = case
    X, edges, node, S = _inputs(7, n, F, B, N, 3, R, shared_x=shared_x,
                                shared_edges=shared_edges, stats="float")
    scale = np.maximum(_scale(X, edges, node, S, N), 1e-30)
    got = _port(X, edges, node, S, N, "float32")
    err = np.abs(got - _jax_ref(X, edges, node, S, N)) / scale
    assert err.max() <= FLOAT_TOL
    # bfloat16 mode: the JAX kernel on S rounded to bf16 the same way
    S16 = torch.from_numpy(S).to(torch.bfloat16).float().numpy()
    got16 = _port(X, edges, node, S, N, "bfloat16")
    err16 = np.abs(got16 - _jax_ref(X, edges, node, S16, N)) / scale
    assert err16.max() <= FLOAT_TOL
    # ...and the rounding is real: bf16 differs from float32 here
    assert np.abs(got16 - got).max() > 0


def test_single_replica_layout_and_cumulative_bins():
    X, edges, node, S = _inputs(3, 300, 5, 8, 4, 3, 1, shared_x=True,
                                shared_edges=True, stats="onehot")
    got = hist.binned_left_stats(
        torch.from_numpy(X), torch.from_numpy(edges),
        torch.from_numpy(node[0]), torch.from_numpy(S[0]), n_nodes=4,
    ).numpy()
    assert got.shape == (5, 8, 4, 3)
    np.testing.assert_array_equal(got, _jax_ref(X, edges, node, S, 4)[0])
    # cumulative in b, and the +inf edge holds every non-NaN row
    assert (np.diff(got, axis=1) >= 0).all()
    finite = np.isfinite(X)
    for f in range(5):
        want = np.zeros((4, 3), np.float32)
        np.add.at(want, node[0][finite[:, f]], S[0][finite[:, f]])
        np.testing.assert_array_equal(got[f, -1], want)


def test_nan_edge_suffix_entries_are_zero():
    # a feature more than 1/B NaN gets NaN quantile edges before +inf
    X, edges, node, S = _inputs(4, 200, 3, 8, 2, 2, 2, shared_x=True,
                                shared_edges=True, stats="onehot")
    edges[1, 5:7] = np.nan
    got = _port(X, edges, node, S, 2, "bfloat16")
    np.testing.assert_array_equal(got, _jax_ref(X, edges, node, S, 2))
    assert (got[:, 1, 5:7] == 0).all()


def test_rows_outside_the_level_contribute_nothing():
    X, edges, node, S = _inputs(5, 200, 4, 8, 4, 2, 2, shared_x=True,
                                shared_edges=True, stats="poisson")
    node[:, ::7] = 9  # beyond n_nodes
    kept = node < 4
    got = _port(X, edges, node, S, 4, "float32")
    want = _port(X, edges, np.where(kept, node, 0).astype(np.int32),
                 S * kept[..., None], 4, "float32")
    np.testing.assert_array_equal(got, want)


def test_geometry_at_the_headline_tree_shapes():
    n, F, B, K = 581_012, 43, 32, 7
    for N in (1, 2, 4, 8, 16):
        for R in (1, 8, 121, 256):
            g = hist.hist_geometry(n, F, B, N, K, R, n_sm=132)
            assert g["f_tiles"] * g["f_tile"] >= F
            assert (g["f_tiles"] - 1) * g["f_tile"] < F
            assert g["n_tiles"] * g["n_tile"] >= N
            assert (g["n_tiles"] - 1) * g["n_tile"] < N
            assert g["rows_per_split"] % g["row_tile"] == 0
            assert g["splits"] * g["rows_per_split"] >= n
            assert (g["splits"] - 1) * g["rows_per_split"] < n
            assert g["smem"] <= hist._SMEM_BYTES
            # staging, histogram, edges and the row counter
            assert g["smem"] == (4 * g["row_tile"] * (K + 2) + 16 + g["f_tile"]
                                 * (g["n_tile"] * 4 * B * K + 4 * B))
    deepest = hist.hist_geometry(n, F, B, 16, K, 121, n_sm=132)
    assert deepest["n_tile"] == 16 and deepest["f_tile"] == 6
    assert deepest["splits"] == 1  # enough blocks without a row split
    shallow = hist.hist_geometry(n, F, B, 1, K, 1, n_sm=132)
    assert shallow["f_tiles"] == 1 and shallow["splits"] > 1
    assert shallow["rows_per_split"] >= hist.MIN_SPLIT_ROWS


def test_geometry_tiles_nodes_and_opts_in_to_more_shared_memory():
    deep = hist.hist_geometry(10_000, 20, 32, 1024, 7, 4, n_sm=132)
    assert deep["n_tiles"] > 1 and deep["f_tile"] == 1
    wide = hist.hist_geometry(10_000, 20, 256, 4, 100, 4, n_sm=132)
    assert hist._SMEM_BYTES < wide["smem"] <= hist._MAX_SMEM_BYTES
    assert wide["f_tile"] == wide["n_tile"] == 1


def test_geometry_refuses_shapes_beyond_the_kernel():
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_geometry(1000, 4, 256, 2, 300, 1, n_sm=132)
    with pytest.raises(ValueError, match="row splits"):
        hist.hist_geometry(2**31 - 1, 4, 4, 1, 1, 1, n_sm=10**7)


def test_launch_bytes():
    assert hist.launch_bytes(43, 32, 16, 7) == 2 * 4.0 * 43 * 32 * 16 * 7


def _valid():
    X, edges, node, S = _inputs(6, 50, 3, 4, 2, 2, 2, shared_x=True,
                                shared_edges=True, stats="onehot")
    return [torch.from_numpy(a) for a in (X, edges, node, S)]


@pytest.mark.parametrize("bad", [
    "hist_dtype", "n_nodes", "x_dtype", "node_dtype", "rows", "features",
    "replicas", "layout", "contiguous",
])
def test_wrapper_validates(bad):
    X, edges, node, S = _valid()
    kw = dict(n_nodes=2, hist_dtype="bfloat16")
    if bad == "hist_dtype":
        kw["hist_dtype"] = "float16"
    elif bad == "n_nodes":
        kw["n_nodes"] = 0
    elif bad == "x_dtype":
        X = X.double()
    elif bad == "node_dtype":
        node = node.long()
    elif bad == "rows":
        S = S[:, :-1].contiguous()
    elif bad == "features":
        edges = edges[:-1].contiguous()
    elif bad == "replicas":
        node = torch.cat([node, node])
    elif bad == "layout":
        S = S[0]
    elif bad == "contiguous":
        X = X.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        hist.binned_left_stats(X, edges, node, S, **kw)


def test_no_fallback_off_the_cpu():
    # a tensor that is neither on the CPU nor on a CUDA device is refused,
    # never computed by the plain version
    X, edges, node, S = (t.to("meta") for t in _valid())
    with pytest.raises(ValueError, match="unsupported device"):
        hist.binned_left_stats(X, edges, node, S, n_nodes=2)
    assert hist.binned_left_stats.launches == 0
