"""The port's split-search histogram (ops/hist.py) against the JAX
package's Pallas kernel, run in interpret mode as tests/test_hist.py
runs it.

On CPU tensors ``binned_left_stats`` computes its plain version, the
dense indicator contraction; ``bin_codes`` and ``coded_left_stats``
(the tree fit's form: bin codes made once, read through each replica's
columns) compute theirs. Tolerances:
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
        for R in (1, 8, 121, 187, 256):
            g = hist.hist_geometry(n, F, B, N, K, R, n_sm=132)
            # nodes are tiled before features: every feature in a block
            assert g["f_tile"] == F and g["f_tiles"] == 1
            assert g["n_tiles"] * g["n_tile"] >= N
            assert (g["n_tiles"] - 1) * g["n_tile"] < N
            assert g["splits"] * g["rows_per_split"] >= n
            assert (g["splits"] - 1) * g["rows_per_split"] < n
            assert g["rows_per_split"] >= hist.MIN_SPLIT_ROWS or g["splits"] == 1
            assert g["cap"] == hist.STAGE_ITEMS
            # three blocks an SM: histogram with its junk bin row,
            # columns, staged items, row list and claim counters
            assert g["smem"] <= hist._SMEM_BYTES
            assert g["smem"] == (4 * (B + 1) * g["b_stride"] + 4 * F
                                 + 12 * g["cap"] + 4 * hist._LIST_ROWS + 24)
    deepest = hist.hist_geometry(n, F, B, 16, K, 187, n_sm=132)
    assert deepest["n_tile"] == 1 and deepest["n_tiles"] == 16
    assert deepest["b_stride"] == 320  # 7 x 43 = 301 words, padded to 32s
    assert deepest["splits"] == 1  # enough blocks without a row split
    shallow = hist.hist_geometry(n, F, B, 1, K, 1, n_sm=132)
    assert shallow["n_tiles"] == 1 and shallow["splits"] > 1
    assert shallow["rows_per_split"] >= hist.MIN_SPLIT_ROWS


def test_geometry_tiles_nodes_and_opts_in_to_more_shared_memory():
    deep = hist.hist_geometry(10_000, 20, 32, 1024, 7, 4, n_sm=132)
    assert deep["n_tiles"] > 1 and deep["f_tile"] == 20  # nodes, not features
    assert deep["n_tile"] > 1  # several nodes a block where they fit
    wide = hist.hist_geometry(10_000, 20, 256, 4, 100, 4, n_sm=132)
    assert hist._SMEM_BYTES < wide["smem"] <= hist._MAX_SMEM_BYTES
    assert wide["f_tile"] == 1 and wide["n_tile"] == 1  # features tiled
    # one node's full-width histogram fits 227 KB only: one node a block
    full = hist.hist_geometry(10_000, 90, 32, 8, 7, 4, n_sm=132)
    assert full["f_tile"] == 90 and full["n_tile"] == 1
    assert hist._SMEM_BYTES < full["smem"] <= hist._MAX_SMEM_BYTES


def test_geometry_refuses_shapes_beyond_the_kernel():
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_geometry(1000, 4, 256, 2, 300, 1, n_sm=132)
    with pytest.raises(ValueError, match="row splits"):
        hist.hist_geometry(2**31 - 1, 4, 4, 1, 1, 1, n_sm=10**7)
    with pytest.raises(ValueError, match="tiles"):
        hist.hist_geometry(1000, 43, 32, 300_000, 7, 1, n_sm=132)


GEOMETRIES = [  # n, F, B, N, K, R
    (581_012, 43, 32, 16, 7, 187), (581_012, 43, 32, 1, 7, 187),
    (581_012, 43, 32, 2, 7, 69), (10_000, 54, 32, 4, 3, 8),
    (10_000, 5, 16, 8, 7, 2), (10_000, 3, 300, 2, 2, 2),
    (10_000, 20, 256, 4, 100, 4), (10_000, 2000, 32, 4, 7, 2),
    (1000, 1, 8, 1, 1, 1), (1000, 17, 64, 32, 2, 3),
]


@pytest.mark.parametrize("shape", GEOMETRIES)
def test_histogram_layout_is_bank_conflict_free(shape):
    # the features one warp adds for one row (same node and k, any bins)
    # fall on distinct banks: features are fastest (stride 1, odd) and
    # the bin stride is a multiple of the power of two at or above the
    # block's features (32 from 32 on), so 32 consecutive features, or
    # all of fewer, differ mod 32 whatever their bins
    n, F, B, N, K, R = shape
    g = hist.hist_geometry(n, F, B, N, K, R, n_sm=132)
    ft, bs = g["f_tile"], g["b_stride"]
    p = min(32, 1 << (ft - 1).bit_length())
    assert bs % p == 0 and bs >= g["n_tile"] * K * ft
    assert 4 * (B + 1) * bs <= g["smem"]
    rng = np.random.default_rng(sum(shape))
    for _ in range(50):
        nd, k = rng.integers(0, g["n_tile"]), rng.integers(0, K)
        f0 = rng.integers(0, max(1, ft - 31))
        fs = np.arange(f0, min(ft, f0 + 32))
        bins = rng.integers(0, B + 1, fs.size)
        addr = bins * bs + (nd * K + k) * ft + fs
        assert len(set(addr % 32)) == fs.size


@pytest.mark.parametrize("B,K", [
    (32, 7), (6759, 7), (6760, 7), (8000, 7), (22942, 7), (32, 906),
    (32, 907), (32, 1000), (32, 8924), (256, 5403), (5, 50_000), (1, 1),
])
def test_stat_tiles_cover_the_table_once_and_each_fits_a_launch(B, K):
    tiles = hist.stat_tiles(B, K)
    seen = np.zeros((B, K), np.int64)
    for b0, b1, k0, k1 in tiles:
        assert 0 <= b0 < b1 <= B and 0 <= k0 < k1 <= K
        seen[b0:b1, k0:k1] += 1
        hist.hist_geometry(581_012, 43, b1 - b0, 16, k1 - k0, 114, n_sm=132)
    assert (seen == 1).all()
    # one launch exactly where the single-launch geometry takes the shape
    try:
        hist.hist_geometry(1000, 4, B, 1, K, 1, n_sm=132)
        assert len(tiles) == 1
    except ValueError:
        assert len(tiles) > 1


def _tiled_plain(X, edges, node, S, N, tiles):
    """The plain version assembled from (bin, class) slices."""
    R, n, K = S.shape
    F, B = edges.shape[-2:]
    out = np.full((R, F, B, N, K), np.nan, np.float32)
    for b0, b1, k0, k1 in tiles:
        out[:, :, b0:b1, :, k0:k1] = _port(
            X, np.ascontiguousarray(edges[..., b0:b1]), node,
            np.ascontiguousarray(S[..., k0:k1]), N, "float32")
    return out


@pytest.mark.parametrize("tiles", [
    [(0, 3, 0, 5), (3, 8, 0, 5)],
    [(0, 8, 0, 2), (0, 8, 2, 5)],
    [(0, 1, 0, 1), (1, 6, 0, 1), (6, 8, 0, 1), (0, 5, 1, 5), (5, 8, 1, 5)],
])
def test_plain_assembled_from_slices_equals_the_whole(tiles):
    # the separability the tiled launch relies on, bitwise on integer
    # statistics, with NaN rows, x on an edge and a NaN edge suffix
    X, edges, node, S = _inputs(11, 300, 3, 8, 2, 5, 2, shared_x=True,
                                shared_edges=False, stats="poisson")
    edges[0, 1, 5:] = np.nan
    whole = _port(X, edges, node, S, 2, "float32")
    np.testing.assert_array_equal(
        _tiled_plain(X, edges, node, S, 2, tiles), whole)


def _slice_codes(codes, b0):
    """The codes a launch on bins [b0, ...) sees: below b0 into its first
    bin (what the kernel's max(0, code - b0) does)."""
    return torch.clamp(codes.long() - b0, min=0)


def test_tiled_launch_assembles_each_slice(monkeypatch):
    # the wrapper's tiling path, with each launch played by the plain
    # version on its slice: B = 9000 bins (int16 codes) need two launches
    X, edges, node, S = _inputs(12, 64, 5, 9000, 2, 7, 2, shared_x=True,
                                shared_edges=True, stats="onehot")
    rng = np.random.default_rng(12)
    cols = torch.from_numpy(
        np.stack([rng.permutation(5)[:3] for _ in range(2)]).astype(np.int32))
    X, edges, node, S = (torch.from_numpy(a) for a in (X, edges, node, S))
    codes = hist.bin_codes(X, edges)
    assert codes.dtype == torch.int16
    E = edges[cols.long()].contiguous()
    launched = []

    def launch_one(C3, cols, E3, node2, S3, out, b0, n_nodes, hist_dtype,
                   scales):
        launched.append((b0, E3.shape[-1], S3.shape[-1], scales is None))
        out.copy_(hist.coded_left_stats_plain(
            _slice_codes(C3, b0), E3, node2, S3, n_nodes=n_nodes,
            hist_dtype=hist_dtype, cols=cols))

    monkeypatch.setattr(hist, "_launch_one", launch_one)
    got = hist._launch(codes, E, node, S, cols, 2, "float32", True)
    assert launched == [(0, 4500, 7, True), (4500, 4500, 7, True)]
    assert torch.equal(got, hist.coded_left_stats_plain(
        codes, E, node, S, n_nodes=2, hist_dtype="float32", cols=cols))
    # and the gathered-X form agrees
    assert torch.equal(got, hist.binned_left_stats_plain(
        X[:, cols.long()].permute(1, 0, 2).contiguous(), E, node, S,
        n_nodes=2, hist_dtype="float32"))


@pytest.mark.parametrize("tiles", [
    [(0, 3, 0, 5), (3, 8, 0, 5)],
    [(0, 8, 0, 2), (0, 8, 2, 5)],
    [(0, 1, 0, 1), (1, 6, 0, 1), (6, 8, 0, 1), (0, 5, 1, 5), (5, 8, 1, 5)],
])
def test_coded_slices_assemble_the_whole(tiles):
    # a launch on bins [b0, b1) adds a code below b0 into its first bin
    # and drops a code at or above b1: the slices of the codes form
    # assemble the whole table bitwise, with NaN rows, x on an edge, a
    # NaN edge suffix, shared codes and columns
    X, edges, node, S = _inputs(13, 300, 6, 8, 2, 5, 2, shared_x=True,
                                shared_edges=True, stats="poisson")
    edges[1, 5:7] = np.nan
    X, edges, node, S = (torch.from_numpy(a) for a in (X, edges, node, S))
    cols = torch.tensor([[4, 1, 0], [1, 5, 2]], dtype=torch.int32)
    codes = hist.bin_codes(X, edges)
    E = edges[cols.long()].contiguous()
    kw = dict(n_nodes=2, hist_dtype="float32", cols=cols)
    whole = hist.coded_left_stats(codes, E, node, S, **kw)
    out = torch.full_like(whole, float("nan"))
    for b0, b1, k0, k1 in tiles:
        out[:, :, b0:b1, :, k0:k1] = hist.coded_left_stats_plain(
            _slice_codes(codes, b0), E[..., b0:b1].contiguous(), node,
            S[..., k0:k1].contiguous(), **kw)
    assert torch.equal(out, whole)


def test_launch_bytes():
    assert hist.launch_bytes(43, 32, 16, 7) == 2 * 4.0 * 43 * 32 * 16 * 7
    # float statistics: the float32 table and every row split's int64
    # partials (a fixed-point block sums FIXED_SPLIT_ROWS at most)
    assert hist.fixed_splits(800_000) == 25 and hist.fixed_splits(10) == 1
    assert hist.launch_bytes(28, 32, 8, 3, 25, integral=False) == \
        (4.0 + 8.0 * 25) * 28 * 32 * 8 * 3


@pytest.mark.parametrize("R", [1, 32, 128])
def test_fixed_point_geometry_bounds_the_rows_a_block_sums(R):
    # config 7's shape: the int64 fixed point is exact in any split; its
    # entries are twice as wide, so a block holds fewer nodes, and rows
    # split at least every FIXED_SPLIT_ROWS keep more blocks in flight
    n, F, B, K = 800_000, 28, 32, 3
    for N in (1, 8):
        i32 = hist.hist_geometry(n, F, B, N, K, R, n_sm=132)
        fixed = hist.hist_geometry(n, F, B, N, K, R, n_sm=132,
                                   acc_bytes=hist.FIXED_BYTES,
                                   max_split_rows=hist.FIXED_SPLIT_ROWS)
        assert fixed["n_tile"] <= i32["n_tile"]
        assert fixed["splits"] * fixed["rows_per_split"] >= n
        assert fixed["rows_per_split"] <= hist.FIXED_SPLIT_ROWS
        assert fixed["splits"] >= hist.fixed_splits(n)
        assert fixed["smem"] == (8 * (B + 1) * fixed["b_stride"] + 4 * F
                                 + 16 * fixed["cap"]
                                 + 4 * hist._LIST_ROWS + 24)
        assert fixed["smem"] <= hist._MAX_SMEM_BYTES


@pytest.mark.parametrize("shape", GEOMETRIES)
def test_fixed_point_layout_is_bank_conflict_free(shape):
    # the fixed point keeps its low and high words in two 32-bit planes
    # of the int32 layout: in each, the features one warp adds for one
    # row fall on distinct banks, and the planes fill the block's bytes
    n, F, B, N, K, R = shape
    try:
        g = hist.hist_geometry(n, F, B, N, K, R, n_sm=132,
                               acc_bytes=hist.FIXED_BYTES)
    except ValueError:  # a table the fixed point tiles over launches
        assert len(hist.stat_tiles(B, K, hist.FIXED_BYTES)) > 1
        return
    ft, bs = g["f_tile"], g["b_stride"]
    assert bs % min(32, 1 << (ft - 1).bit_length()) == 0
    assert bs >= g["n_tile"] * K * ft
    assert 8 * (B + 1) * bs <= g["smem"] <= hist._MAX_SMEM_BYTES
    plane = (B + 1) * bs
    rng = np.random.default_rng(sum(shape))
    for _ in range(50):
        nd, k = rng.integers(0, g["n_tile"]), rng.integers(0, K)
        f0 = rng.integers(0, max(1, ft - 31))
        fs = np.arange(f0, min(ft, f0 + 32))
        bins = rng.integers(0, B + 1, fs.size)
        lo = bins * bs + (nd * K + k) * ft + fs
        for words in (lo, lo + plane):
            assert len(set(words % 32)) == fs.size


@pytest.mark.parametrize("B,K", [(32, 7), (6000, 7), (32, 1000), (256, 3)])
def test_fixed_point_stat_tiles_fit_a_launch(B, K):
    tiles = hist.stat_tiles(B, K, hist.FIXED_BYTES)
    seen = np.zeros((B, K), np.int64)
    for b0, b1, k0, k1 in tiles:
        seen[b0:b1, k0:k1] += 1
        hist.hist_geometry(581_012, 43, b1 - b0, 16, k1 - k0, 114, n_sm=132,
                           acc_bytes=hist.FIXED_BYTES)
    assert (seen == 1).all()
    assert len(tiles) >= len(hist.stat_tiles(B, K))


@pytest.mark.parametrize("n,amax", [(1, 1.0), (300, 3.5), (800_000, 0.02),
                                    (581_012, 7.0), (10, 0.0),
                                    (1000, 2.0**-120), (1000, 3e37)])
def test_fixed_scales_bound_every_sum_below_2_52(n, amax):
    S = torch.zeros((2, n, 3), dtype=torch.float32)
    S[0, 0, 1] = -amax
    S[1, -1, 2] = amax / 3
    scale, inv = hist.fixed_scales(S)
    assert scale.dtype == torch.float32 and inv.dtype == torch.float64
    for r in range(2):
        m, e = np.frexp(np.float32(np.abs(S[r]).max()))
        s = int(np.clip(52 - n.bit_length() - e, -100, 100))
        assert float(scale[r]) == 2.0**s and float(inv[r]) == 2.0**-s
        if -100 < s < 100:  # the bound holds wherever the clamp is idle
            assert n * float(np.abs(S[r]).max()) * 2.0**s <= 2.0**52


def _float_stats(seed, n, K=3):
    rng = np.random.default_rng(seed)
    w = rng.poisson(1.0, (2, n)).astype(np.float32)
    yv = (rng.standard_normal(n) * 3.0).astype(np.float32)
    S = np.stack([w, w * yv, w * yv * yv], axis=-1)[..., :K]
    return torch.from_numpy(np.ascontiguousarray(S, np.float32))


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_fixed_point_table_is_the_same_in_any_row_order(mode):
    # the sums are integers: the rows in reverse and shuffled give the
    # same table bit for bit, as the kernel's atomics in any order do
    n, F, B, N = 700, 4, 16, 3
    X, edges, node, _ = _inputs(31, n, F, B, N, 3, 2, shared_x=True,
                                shared_edges=True, stats="float")
    S = _float_stats(31, n)
    X, edges, node = (torch.from_numpy(a) for a in (X, edges, node))
    codes = hist.bin_codes(X, edges)
    kw = dict(n_nodes=N, hist_dtype=mode)
    want = hist.coded_left_stats_fixed(codes, edges, node, S, **kw)
    for perm in (torch.arange(n - 1, -1, -1),
                 torch.from_numpy(np.random.default_rng(3).permutation(n))):
        got = hist.coded_left_stats_fixed(
            codes[perm].contiguous(), edges, node[:, perm].contiguous(),
            S[:, perm].contiguous(), **kw)
        assert torch.equal(got, want)


def test_fixed_point_table_within_one_rounding_of_float64():
    # each entry is the float32 rounding of an exact integer sum: within
    # 2**-24 of the entry plus the quantization (n 2**-(s+1) at most)
    # of the float64 sum of the same terms
    n, F, B, N = 2000, 5, 16, 4
    X, edges, node, _ = _inputs(32, n, F, B, N, 3, 2, shared_x=True,
                                shared_edges=True, stats="float")
    S = _float_stats(32, n)
    X, edges, node = (torch.from_numpy(a) for a in (X, edges, node))
    codes = hist.bin_codes(X, edges)
    got = hist.coded_left_stats_fixed(codes, edges, node, S, n_nodes=N,
                                hist_dtype="float32").double()
    T = (codes.long()[:, :, None] <= torch.arange(B)).double()
    _, inv = hist.fixed_scales(S)
    for r in range(2):
        onehot = torch.nn.functional.one_hot(node[r].long(), N).double()
        st = (onehot[:, :, None] * S[r].double()[:, None, :]).reshape(n, -1)
        want = (T.reshape(n, -1).t() @ st).reshape(F, B, N, 3)
        bound = want.abs() * 2.0**-24 + n * float(inv[r]) / 2
        assert ((got[r] - want).abs() <= bound).all()


def test_fixed_point_replica_tables_do_not_depend_on_the_chunk():
    # a replica's scale comes from its own statistics: fitted alone or
    # in a chunk with a replica of larger values, its table is the same
    n, F, B, N = 300, 3, 8, 2
    X, edges, node, _ = _inputs(33, n, F, B, N, 3, 2, shared_x=True,
                                shared_edges=True, stats="float")
    S = _float_stats(33, n)
    S[1] *= 1000.0
    X, edges, node = (torch.from_numpy(a) for a in (X, edges, node))
    codes = hist.bin_codes(X, edges)
    kw = dict(n_nodes=N, hist_dtype="float32")
    both = hist.coded_left_stats_fixed(codes, edges, node, S, **kw)
    for r in range(2):
        alone = hist.coded_left_stats_fixed(codes, edges, node[r:r + 1],
                                      S[r:r + 1].contiguous(), **kw)
        assert torch.equal(alone[0], both[r])


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
    with pytest.raises(ValueError, match="unsupported device"):
        hist.bin_codes(X, edges)
    codes = torch.zeros(X.shape, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hist.coded_left_stats(codes, edges, node, S, n_nodes=2)
    assert hist.binned_left_stats.launches == 0
    assert hist.bin_codes.launches == 0


def _valid_coded():
    X, edges, node, S = _valid()
    cols = torch.tensor([[2, 0, 1], [1, 2, 0]], dtype=torch.int32)
    return hist.bin_codes(X, edges), cols, edges[cols.long()].contiguous(), \
        node, S


@pytest.mark.parametrize("bad", [
    "hist_dtype", "n_nodes", "codes_dtype", "cols_dtype", "cols_replicas",
    "features", "rows", "layout", "contiguous", "devices",
])
def test_coded_wrapper_validates(bad):
    codes, cols, edges, node, S = _valid_coded()
    kw = dict(n_nodes=2, hist_dtype="bfloat16")
    if bad == "hist_dtype":
        kw["hist_dtype"] = "float16"
    elif bad == "n_nodes":
        kw["n_nodes"] = 0
    elif bad == "codes_dtype":
        codes = codes.to(torch.int16)  # 4 bins need uint8 codes
    elif bad == "cols_dtype":
        cols = cols.long()
    elif bad == "cols_replicas":
        cols = torch.cat([cols, cols])
    elif bad == "features":
        cols = cols[:, :2].contiguous()
    elif bad == "rows":
        codes = codes[:-1].contiguous()
    elif bad == "layout":
        S = S[0]
    elif bad == "contiguous":
        cols = cols.t().contiguous().t()
    elif bad == "devices":
        cols = cols.to("meta")
    with pytest.raises((ValueError, TypeError)):
        hist.coded_left_stats(codes, edges, node, S, cols=cols, **kw)


@pytest.mark.parametrize("bad", ["dtype", "features", "replicas", "bins",
                                 "contiguous"])
def test_bin_codes_validates(bad):
    X, edges, _, _ = _valid()
    if bad == "dtype":
        X = X.double()
    elif bad == "features":
        edges = edges[:-1].contiguous()
    elif bad == "replicas":
        X, edges = torch.stack([X] * 2), torch.stack([edges] * 3)
    elif bad == "bins":  # beyond int16 codes: the limit is named
        edges = torch.zeros((X.shape[1], hist.MAX_BINS + 1))
        with pytest.raises(ValueError, match="32766 bins"):
            hist.bin_codes(X, edges)
        return
    elif bad == "contiguous":
        X = X.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        hist.bin_codes(X, edges)


def _indicator_inputs(seed, n, F, B):
    """X with NaN entries, x on (duplicated) edges, +-inf; ascending edges
    ending in +inf, with duplicates and a NaN-edge suffix."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F)).astype(np.float32)
    e = np.sort(rng.standard_normal((F, B - 1)), axis=-1).astype(np.float32)
    edges = np.concatenate([e, np.full((F, 1), np.inf, np.float32)], axis=1)
    edges[0, B // 2:B - 1] = np.nan          # NaN edge suffix
    edges[1, 1:4] = edges[1, 1]              # duplicate edges
    X[::5, 0] = np.nan
    X[::3, 1] = edges[1, 1]                  # on a duplicated edge
    X[::7, 2 % F] = np.inf
    X[::11, 2 % F] = -np.inf
    X[4] = np.nan                            # a NaN row
    return X, edges


@pytest.mark.parametrize("B", [8, 255, 300])
def test_bin_codes_equal_the_jax_indicator(B):
    # the indicator [code <= b] (0 at NaN edges) against the JAX kernel's
    # own indicator [X <= E], read off its table with one statistic per
    # row (S = I), in interpret mode as tests/test_hist.py runs it
    n, F = 48, 3
    X, edges = _indicator_inputs(B, n, F, B)
    codes = hist.bin_codes(torch.from_numpy(X), torch.from_numpy(edges))
    assert codes.dtype == (torch.uint8 if B <= 255 else torch.int16)
    assert codes.shape == (n, F)
    assert int(codes.max()) <= B and (codes[4] == B).all()
    ind = ((codes.long()[:, :, None] <= torch.arange(B))
           & ~torch.isnan(torch.from_numpy(edges))[None])
    jax_ind = np.asarray(jax_hist(
        jnp.asarray(X), jnp.asarray(edges), jnp.zeros(n, jnp.int32),
        jnp.eye(n, dtype=jnp.float32), n_nodes=1, interpret=True))[:, :, 0, :]
    np.testing.assert_array_equal(ind.permute(1, 2, 0).numpy().astype(
        np.float32), jax_ind)


def test_bin_codes_per_replica_edges_and_x():
    X, edges = _indicator_inputs(3, 40, 4, 16)
    Xs = torch.from_numpy(np.stack([X, X[::-1].copy()]))
    Es = torch.from_numpy(np.stack([edges, edges]))
    got = hist.bin_codes(Xs, Es)
    assert got.shape == (2, 40, 4)
    for r in range(2):
        assert torch.equal(got[r], hist.bin_codes(Xs[r], Es[r]))
    # a shared X with per-replica edges gives per-replica codes
    assert hist.bin_codes(Xs[0], Es).shape == (2, 40, 4)


@pytest.mark.parametrize("stats", ["onehot", "poisson", "float"])
@pytest.mark.parametrize("layout", ["shared_cols", "replica_codes",
                                    "identity"])
def test_coded_plain_equals_binned_plain_on_gathered_x(layout, stats):
    # the same indicator, so the same float32 contraction: bit for bit,
    # float statistics included, in both modes
    n, F_all, F, B, N, K, R = 400, 7, 5, 16, 4, 3, 3
    X, edges, node, S = _inputs(21, n, F_all, B, N, K, R, shared_x=True,
                                shared_edges=True, stats=stats)
    edges[2, 9:15] = np.nan
    X, edges, node, S = (torch.from_numpy(a) for a in (X, edges, node, S))
    rng = np.random.default_rng(21)
    idx = torch.from_numpy(np.stack(
        [rng.permutation(F_all)[:F] for _ in range(R)]).astype(np.int32))
    if layout == "identity":
        idx = torch.arange(F_all, dtype=torch.int32).expand(R, F_all)
    codes = hist.bin_codes(X, edges)
    Xg = X[:, idx.long()].permute(1, 0, 2).contiguous()
    E = edges[idx.long()].contiguous()
    cols = idx.contiguous()
    if layout == "replica_codes":
        codes, cols = codes[:, idx.long()].permute(1, 0, 2).contiguous(), None
    elif layout == "identity":
        cols = None
    for mode in ("float32", "bfloat16"):
        got = hist.coded_left_stats(codes, E, node, S, n_nodes=N,
                                    hist_dtype=mode, cols=cols)
        want = hist.binned_left_stats_plain(Xg, E, node, S, n_nodes=N,
                                            hist_dtype=mode)
        assert torch.equal(got, want), mode


def test_coded_matches_the_jax_kernel_through_columns():
    # the tree fit's form against the JAX kernel on each replica's
    # gathered columns, integer statistics, bitwise
    n, F_all, F, B, N, K, R = 300, 6, 4, 8, 4, 3, 2
    X, edges, node, S = _inputs(22, n, F_all, B, N, K, R, shared_x=True,
                                shared_edges=True, stats="onehot")
    cols = np.array([[5, 0, 3, 1], [2, 4, 0, 5]], np.int32)
    Xg = np.ascontiguousarray(X[:, cols].transpose(1, 0, 2))
    E = np.ascontiguousarray(edges[cols])
    got = hist.coded_left_stats(
        hist.bin_codes(torch.from_numpy(X), torch.from_numpy(edges)),
        torch.from_numpy(E), torch.from_numpy(node), torch.from_numpy(S),
        n_nodes=N, cols=torch.from_numpy(cols), integral=True)
    np.testing.assert_array_equal(got.numpy(), _jax_ref(Xg, E, node, S, N))
