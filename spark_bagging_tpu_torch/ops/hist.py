"""Binned left statistics: one tree level's split-search histogram.

For every (feature f, bin edge b, node n, statistic k) of a tree level,

    out[f, b, n, k] = sum_i [X[i, f] <= edges[f, b]] * [node_i == n] * S[i, k]

the weighted class counts (or regression moments) left of each
candidate threshold (models/tree.py). Edges ascend along b and end in
+inf, so the table is cumulative in b.

``binned_left_stats`` computes it for a chunk of replicas: on a CUDA
tensor it launches the Hopper kernel of ``csrc/binned_left_stats.cu``;
on a CPU tensor it computes :func:`binned_left_stats_plain`, the same
function in plain torch. A CUDA tensor never takes the plain path: the
kernel launches or the call raises.

Layouts: ``X (n, F)`` shared by every replica or ``(R, n, F)`` (each
replica's gathered feature subspace); ``edges (F, B)`` or ``(R, F, B)``;
``node (R, n)`` int32; ``S (R, n, K)`` float32; the output is
``(R, F, B, n_nodes, K)`` float32. ``node (n,)`` with ``S (n, K)`` (and
a 2-D X and edges) is the JAX package's single-replica signature and
gives ``(F, B, n_nodes, K)``. Rows whose node lies outside
``[0, n_nodes)`` and NaN entries of X contribute nothing.

``hist_dtype`` is the statistics' operand type: ``"bfloat16"`` rounds S
to bfloat16 before it is summed in float32, ``"float32"`` sums it as
given. The 0/1 indicator is exact in either. With integer statistics
below 256 (Poisson counts times one-hot classes) both are exact, and so
is every sum below 2**24, whatever the order.

Edges must be non-decreasing along b; NaN edges (the quantile edges of a
feature that is more than 1/B NaN) may only form a suffix, and their
entries are 0, as the indicator gives.
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.ops.precision import bf16_round, fp32_matmul

_HIST_DTYPES = ("float32", "bfloat16")
# The kernel's compile-time block size, decided here only: utils/native.py
# passes it to nvcc as a -D define, and csrc/binned_left_stats.cu refuses
# to build without it.
CUDA_DEFINES = {"SBT_HIST_THREADS": 512}
_THREADS = CUDA_DEFINES["SBT_HIST_THREADS"]
# dynamic shared memory a block aims for: two blocks fit an H100 SM's
# 228 KB; and the most one block can opt in to
_SMEM_BYTES = 112 * 1024
_MAX_SMEM_BYTES = 232_448
# shared bytes for one row tile's staged rows (index, node, K statistics)
_STAGE_BYTES = 16 * 1024
_MAX_ROW_TILE = 512
# blocks in flight the row split aims for, per streaming multiprocessor
_BLOCKS_PER_SM = 2
# rows below which a launch is not split further for occupancy: bounds
# the partials' memory at few replicas
MIN_SPLIT_ROWS = 4096


def _as_batched(X, edges, node, S):
    """(X (R|1, n, F), edges (R|1, F, B), node (R, n), S (R, n, K),
    squeeze) for the accepted layouts."""
    squeeze = S.dim() == 2
    if squeeze:
        node, S = node[None], S[None]
    X3 = X[None] if X.dim() == 2 else X
    E3 = edges[None] if edges.dim() == 2 else edges
    return X3, E3, node, S, squeeze


def binned_left_stats_plain(
    X: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
) -> torch.Tensor:
    """The plain torch version of the kernel, the same function: the
    dense ``(F·B, n) x (n, N·K)`` contraction of the threshold indicator
    with the node-scattered statistics (the JAX package's dense split
    search), in float32 with TF32 off, one replica at a time."""
    X3, E3, node2, S3, squeeze = _as_batched(X, edges, node, S)
    R, n, K = S3.shape
    F, B = E3.shape[-2:]
    out = torch.empty((R, F, B, n_nodes, K), dtype=torch.float32,
                      device=S3.device)
    ids = torch.arange(n_nodes, device=S3.device)
    for r in range(R):
        x = X3[r if X3.shape[0] > 1 else 0]
        e = E3[r if E3.shape[0] > 1 else 0]
        T = (x[:, :, None] <= e[None]).reshape(n, F * B).to(torch.float32)
        s = S3[r].to(torch.float32)
        if hist_dtype == "bfloat16":
            s = bf16_round(s)
        onehot = (node2[r][:, None] == ids).to(torch.float32)
        stats = (onehot[:, :, None] * s[:, None, :]).reshape(n, n_nodes * K)
        with fp32_matmul():
            out[r] = (T.t() @ stats).reshape(F, B, n_nodes, K)
    return out[0] if squeeze else out


def _check(X, edges, node, S, n_nodes, hist_dtype) -> None:
    if hist_dtype not in _HIST_DTYPES:
        raise ValueError(
            f"hist_dtype must be one of {_HIST_DTYPES}, got {hist_dtype!r}")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    for name, t in (("X", X), ("edges", edges), ("S", S)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if node.dtype != torch.int32:
        raise TypeError(f"node must be int32, got {node.dtype}")
    if len({t.device for t in (X, edges, node, S)}) != 1:
        raise ValueError("X, edges, node and S must lie on one device")
    if S.dim() == 2:
        if (X.dim(), edges.dim(), node.dim()) != (2, 2, 1):
            raise ValueError("a 2-D S needs a 2-D X and edges and a 1-D node")
    elif S.dim() != 3 or node.dim() != 2 or X.dim() not in (2, 3) \
            or edges.dim() not in (2, 3):
        raise ValueError(
            f"expected S (R, n, K), node (R, n), X (n, F) or (R, n, F), "
            f"edges (F, B) or (R, F, B); got {tuple(S.shape)}, "
            f"{tuple(node.shape)}, {tuple(X.shape)}, {tuple(edges.shape)}")
    if S.dim() == 3:
        reps = {S.shape[0], node.shape[0]}
        reps |= {t.shape[0] for t in (X, edges) if t.dim() == 3}
        if len(reps) > 1:
            raise ValueError(f"replica counts disagree: {sorted(reps)}")
    n = S.shape[-2]
    if node.shape[-1] != n or X.shape[-2] != n:
        raise ValueError(
            f"row counts disagree: S {n}, node {node.shape[-1]}, "
            f"X {X.shape[-2]}")
    if X.shape[-1] != edges.shape[-2]:
        raise ValueError(
            f"X has {X.shape[-1]} features, edges {edges.shape[-2]}")
    if not all(t.is_contiguous() for t in (X, edges, node, S)):
        raise ValueError("X, edges, node and S must be contiguous")


def _row_tile(K: int) -> int:
    return min(_MAX_ROW_TILE, max(32, _STAGE_BYTES // (4 * (K + 2)) // 32 * 32))


def _slice_smem(B: int, K: int) -> int:
    """Shared bytes of the smallest block: one feature's ``(B, K)``
    histogram of one node, its edges, a staged row tile and the row
    counter."""
    return 4 * _row_tile(K) * (K + 2) + 4 * B * K + 4 * B + 16


def hist_geometry(n: int, F: int, B: int, n_nodes: int, K: int, R: int,
                  n_sm: int) -> dict:
    """Launch geometry of the CUDA kernel for one launch (pure
    arithmetic, so the CPU tests can check it). A block keeps a
    ``(f_tile, B, n_tile, K)`` float32 histogram in shared memory beside
    ``f_tile`` rows of edges and one staged row tile; the grid is
    (replica, feature tile x node tile, row split). Full node width
    first, then as many features as fit 112 KB, with the tiles evened
    out; a single (feature, node) slice wider than that takes up to
    227 KB, and beyond that one launch refuses the shape
    (:func:`stat_tiles` splits such a table over launches)."""
    row_tile = _row_tile(K)
    stage = 4 * row_tile * (K + 2)
    unit = 4 * B * K              # one feature's histogram of one node
    room = _SMEM_BYTES - stage
    n_tile = max(1, min(n_nodes, (room - 4 * B) // unit))
    n_tile = math.ceil(n_nodes / math.ceil(n_nodes / n_tile))
    n_tiles = math.ceil(n_nodes / n_tile)
    f_tile = max(1, min(F, room // (n_tile * unit + 4 * B)))
    f_tile = math.ceil(F / math.ceil(F / f_tile))
    f_tiles = math.ceil(F / f_tile)
    # + 16: the block's row counter, after the staged rows
    smem = stage + f_tile * (n_tile * unit + 4 * B) + 16
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"B={B}, K={K}: one feature's histogram of one node needs "
            f"{smem} bytes of shared memory with its staging, beyond the "
            f"{_MAX_SMEM_BYTES} a block can have; use fewer bins or "
            "split_impl='dense'")
    if f_tiles * n_tiles > 65535:  # the grid's y extent
        raise ValueError(f"{f_tiles * n_tiles} feature x node tiles "
                         "(at most 65535)")
    want = max(1, math.ceil(_BLOCKS_PER_SM * n_sm / (R * f_tiles * n_tiles)))
    rows_per_split = max(MIN_SPLIT_ROWS, math.ceil(n / want))
    rows_per_split = row_tile * math.ceil(rows_per_split / row_tile)
    splits = max(1, math.ceil(n / rows_per_split))
    if splits > 65535:  # the grid's z extent
        raise ValueError(f"n={n} rows need {splits} row splits (at most 65535)")
    return dict(f_tile=f_tile, n_tile=n_tile, f_tiles=f_tiles,
                n_tiles=n_tiles, row_tile=row_tile, splits=splits,
                rows_per_split=rows_per_split, smem=smem, threads=_THREADS)


def stat_tiles(B: int, K: int) -> list[tuple[int, int, int, int]]:
    """Contiguous ``(b0, b1, k0, k1)`` tiles that cover ``[0, B) x
    [0, K)`` exactly once, each small enough for one launch (pure
    arithmetic). The table is separable along both axes: entry
    ``[f, b, n, k]`` is the sum of ``[x <= edges[f, b]] [node = n]
    S[k]``, and over a contiguous range of ascending edges the first
    edge at or above x gives the same indicator, so a launch on
    ``edges[..., b0:b1]`` and ``S[..., k0:k1]`` computes
    ``out[..., b0:b1, :, k0:k1]``. Classes are split only where one bin
    of all classes does not fit; then bins are split as evenly as fits.
    One tile where the whole ``(B, K)`` slice fits."""
    n_k = 1
    while _slice_smem(1, math.ceil(K / n_k)) > _MAX_SMEM_BYTES:
        n_k += 1
    kt = math.ceil(K / n_k)
    stage = _slice_smem(0, kt)
    bt = min(B, (_MAX_SMEM_BYTES - stage) // (4 * kt + 4))
    n_b = math.ceil(B / bt)
    bt = math.ceil(B / n_b)
    return [(b0, min(B, b0 + bt), k0, min(K, k0 + kt))
            for k0 in range(0, K, kt) for b0 in range(0, B, bt)]


def launch_bytes(F: int, B: int, n_nodes: int, K: int) -> float:
    """Device bytes one replica adds to a launch of many replicas: its
    ``(F, B, n_nodes, K)`` output and as much again for the row-split
    partials (a launch of few replicas splits rows finer, but is
    small)."""
    return 2 * 4.0 * F * B * n_nodes * K


def _launch_one(X3, E3, node2, S3, out, n_nodes, hist_dtype):
    """One kernel launch: ``out`` (R, F, B, n_nodes, K) from batched
    operands whose ``(B, K)`` slice fits one block."""
    from spark_bagging_tpu_torch.utils import native

    R, n, K = S3.shape
    F, B = E3.shape[-2:]
    dev = S3.device
    g = hist_geometry(
        n, F, B, n_nodes, K, R,
        torch.cuda.get_device_properties(dev).multi_processor_count,
    )
    partials = (
        torch.empty((g["splits"], *out.shape), dtype=torch.float32, device=dev)
        if g["splits"] > 1 else out
    )
    lib = native.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sbt_binned_left_stats(
            X3.data_ptr(), 0 if X3.shape[0] == 1 else n * F,
            E3.data_ptr(), 0 if E3.shape[0] == 1 else F * B,
            node2.data_ptr(), S3.data_ptr(), out.data_ptr(),
            partials.data_ptr(), n, F, B, n_nodes, K, R,
            g["f_tile"], g["n_tile"], g["f_tiles"], g["n_tiles"],
            g["row_tile"], g["splits"], g["rows_per_split"], g["smem"],
            int(hist_dtype == "bfloat16"), stream,
        )
    native.check(lib, err, "binned_left_stats")
    binned_left_stats.launches += 1


def _launch(X, edges, node, S, n_nodes, hist_dtype):
    X3, E3, node2, S3, squeeze = _as_batched(X, edges, node, S)
    R, n, K = S3.shape
    F, B = E3.shape[-2:]
    out = torch.empty((R, F, B, n_nodes, K), dtype=torch.float32,
                      device=S.device)
    if n == 0 or R == 0 or F == 0 or K == 0:
        out.zero_()
        return out[0] if squeeze else out
    tiles = stat_tiles(B, K)
    if len(tiles) == 1:
        _launch_one(X3, E3, node2, S3, out, n_nodes, hist_dtype)
    else:
        for b0, b1, k0, k1 in tiles:
            part = torch.empty((R, F, b1 - b0, n_nodes, k1 - k0),
                               dtype=torch.float32, device=S.device)
            _launch_one(X3, E3[..., b0:b1].contiguous(), node2,
                        S3[..., k0:k1].contiguous(), part, n_nodes,
                        hist_dtype)
            out[:, :, b0:b1, :, k0:k1] = part
    return out[0] if squeeze else out


def binned_left_stats(
    X: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
) -> torch.Tensor:
    """``(R, F, B, n_nodes, K)`` left statistics of one tree level (see
    the module docstring); ``(F, B, n_nodes, K)`` for the 2-D layout.

    ``binned_left_stats.launches`` counts kernel launches (CUDA tensors
    only).
    """
    _check(X, edges, node, S, n_nodes, hist_dtype)
    if S.device.type == "cpu":
        return binned_left_stats_plain(X, edges, node, S, n_nodes=n_nodes,
                                       hist_dtype=hist_dtype)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    return _launch(X, edges, node, S, n_nodes, hist_dtype)


binned_left_stats.launches = 0
