"""Binned left statistics: one tree level's split-search histogram.

For every (feature f, bin edge b, node n, statistic k) of a tree level,

    out[f, b, n, k] = sum_i [X[i, f] <= edges[f, b]] * [node_i == n] * S[i, k]

the weighted class counts (or regression moments) left of each
candidate threshold (models/tree.py). Edges ascend along b and end in
+inf, so the table is cumulative in b.

Two entry points compute it for a chunk of replicas:

- ``binned_left_stats(X, edges, node, S)``, the JAX package's function:
  on a CPU tensor :func:`binned_left_stats_plain`, the dense indicator
  contraction in plain torch; on a CUDA tensor the two Hopper kernels of
  ``csrc/binned_left_stats.cu``: :func:`bin_codes`, then the histogram
  of the codes with identity columns;
- ``coded_left_stats(codes, edges, node, S, cols=)``, what the tree fit
  calls: the same table from bin codes made once per fit (``code[i, f]``
  is the first b with ``X[i, f] <= edges[f, b]``, NaN edges read as
  +inf; B where there is none), read through each replica's column
  index ``cols``, so no replica copies X. For ascending edges
  ``[x <= edges[b]] == [code <= b]``, so the table is the cumulative sum
  over b of a histogram of the codes. On a CPU tensor
  :func:`coded_left_stats_plain`.

A CUDA tensor never takes a plain version: the kernel launches or the
call raises. ``bin_codes.launches`` counts the codes kernel's launches,
``binned_left_stats.launches`` the histogram kernel's (through either
entry point), and ``binned_left_stats.float_launches`` those of them
that sum in the float accumulator (``integral=False``).

Layouts: ``X (n, F)`` shared by every replica or ``(R, n, F)``;
``edges (F, B)`` or ``(R, F, B)``; ``node (R, n)`` int32; ``S (R, n,
K)`` float32; the output is ``(R, F, B, n_nodes, K)`` float32. ``node
(n,)`` with ``S (n, K)`` (and a 2-D X and edges) is the JAX package's
single-replica signature of ``binned_left_stats`` and gives ``(F, B,
n_nodes, K)``. ``codes (n, F_all)`` shared or ``(R, n, F_all)``, uint8
for B <= 255 bins and int16 up to 32,766; ``cols (R, F)`` int32 columns
of the codes in [0, F_all), or None for the identity. Rows whose node
lies outside ``[0, n_nodes)`` and NaN entries of X contribute nothing.

``hist_dtype`` is the statistics' operand type: ``"bfloat16"`` rounds S
to bfloat16 before it is summed, ``"float32"`` sums it as given. The 0/1
indicator is exact in either.

Both of the kernel's accumulators sum integers, so a card table is the
same in every run, whatever order the atomics land in.
``integral=True`` (a caller whose statistics are integers, as the
classifier tree's are) sums them in int32. Float statistics (the
default) are summed in fixed point: replica r's values are scaled by a
power of two ``2**s_r`` (:func:`fixed_scales`, from ``max |S_r|`` and
the row count, so every sum of the table stays below 2**52), rounded to
int64, summed exactly, and each entry converted back once,
``float32(float64(sum) * 2**-s_r)``. :func:`coded_left_stats_fixed` is
that accumulator's plain version, bit for bit on any device. Against
the float64 sum of the unrounded terms an entry is off by its one
float32 rounding plus at most ``m 2**-(s_r + 1)`` for m terms, ~1e-10
of ``max |S_r|`` a term at a million rows.

The CPU path of both entry points is the float32 contraction: exact for
integer statistics below 2**24, and for float statistics the JAX
package's own float32 rounding (the fixed point's exact sums resolve a
near-tie between two splits otherwise than JAX's float32 sums do).

Edges must be non-decreasing along b; NaN edges (the quantile edges of a
feature that is more than 1/B NaN) may only form a suffix, and their
entries are 0, as the indicator gives.
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.ops import kernels
from spark_bagging_tpu_torch.ops.kernels import I32, I64, VP
from spark_bagging_tpu_torch.ops.precision import bf16_round, fp32_matmul
from spark_bagging_tpu_torch.ops.ranges import profiler_range

_HIST_DTYPES = ("float32", "bfloat16")
# The kernel's compile-time block size and the rows a thread lists a
# pass, decided here only: ops/kernels.py passes them to nvcc as -D
# defines, and csrc/binned_left_stats.cu refuses to build without them.
CUDA_DEFINES = {"SBT_HIST_THREADS": 512, "SBT_HIST_ROWS_PER_THREAD": 4}
_THREADS = CUDA_DEFINES["SBT_HIST_THREADS"]
# the block's row list: a pass's rows and the fewer than a block's
# threads still waiting from earlier passes
_LIST_ROWS = _THREADS * (CUDA_DEFINES["SBT_HIST_ROWS_PER_THREAD"] + 1)
# dynamic shared memory a block aims for: three blocks fit an H100 SM's
# 228 KB (at the headline level more blocks in flight beat fewer node
# tiles); and the most one block can opt in to
_SMEM_BYTES = 72 * 1024
_MAX_SMEM_BYTES = 232_448
# one staged item (a nonzero statistic of a kept row): its row's code
# offset and its (node, k) offset in the histogram, and its addend in
# the accumulator's type (4 bytes int32, 8 fixed point)
_ITEM_INDEX_BYTES = 8
# the accumulators' bytes: int32 for integral statistics, int64 fixed
# point for float ones
INT32_BYTES, FIXED_BYTES = 4, 8
# every sum of a fixed-point table stays below 2**FIXED_SUM_BITS, where
# float64 holds it exactly; the scales stay normal float32 powers of two
FIXED_SUM_BITS = 52
_FIXED_MAX_SHIFT = 100
# the items a block stages before it walks them (a pass of rows with
# more items fills the buffer in rounds)
STAGE_ITEMS = 1536
# blocks in flight the row split aims for, per streaming multiprocessor
# (three fit: a shallow level's row splits then run in one wave)
_BLOCKS_PER_SM = 2
# rows below which a launch is not split further for occupancy: bounds
# the partials' memory at few replicas
MIN_SPLIT_ROWS = 4096
# the most rows one block sums in fixed point. Both accumulators are
# exact in any split: this bound is for speed. The fixed point's
# histogram is twice as wide, so fewer nodes share a block; more,
# shorter row splits keep the SMs busy (on config 7's shapes no bound
# and 16,384 were both slower)
FIXED_SPLIT_ROWS = 32_768
# the most bins bin codes hold: codes run to B, in int16
MAX_BINS = 32_766
# The profiler ranges around every call of the entry points: a level's
# histogram launches and finalize, and the bin codes, whatever implements
# them (binned_left_stats's codes fall in both)
HIST_RANGE = "histogram"
CODES_RANGE = "bin_codes"


def code_dtype(n_bins: int) -> torch.dtype:
    """The bin codes' type for ``n_bins`` edges: codes run 0..n_bins."""
    if n_bins > MAX_BINS:
        raise ValueError(
            f"{n_bins} bins: bin codes hold at most {MAX_BINS} bins "
            "(int16); use fewer bins")
    return torch.uint8 if n_bins <= 255 else torch.int16


def _as_batched(X, edges, node, S):
    """(X (R|1, n, F), edges (R|1, F, B), node (R, n), S (R, n, K),
    squeeze) for the accepted layouts."""
    squeeze = S.dim() == 2
    if squeeze:
        node, S = node[None], S[None]
    X3 = X[None] if X.dim() == 2 else X
    E3 = edges[None] if edges.dim() == 2 else edges
    return X3, E3, node, S, squeeze


def _stats_matrix(node, S, n_nodes, hist_dtype):
    """The ``(n, n_nodes·K)`` node-scattered float32 statistics of one
    replica, rounded to bfloat16 first in that mode."""
    s = S.to(torch.float32)
    if hist_dtype == "bfloat16":
        s = bf16_round(s)
    ids = torch.arange(n_nodes, device=S.device)
    onehot = (node[:, None] == ids).to(torch.float32)
    return (onehot[:, :, None] * s[:, None, :]).reshape(S.shape[0], -1)


def binned_left_stats_plain(
    X: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
) -> torch.Tensor:
    """The plain torch version of the function: the dense ``(F·B, n) x
    (n, N·K)`` contraction of the threshold indicator with the
    node-scattered statistics (the JAX package's dense split search), in
    float32 with TF32 off, one replica at a time."""
    X3, E3, node2, S3, squeeze = _as_batched(X, edges, node, S)
    R, n, K = S3.shape
    F, B = E3.shape[-2:]
    out = torch.empty((R, F, B, n_nodes, K), dtype=torch.float32,
                      device=S3.device)
    for r in range(R):
        x = X3[r if X3.shape[0] > 1 else 0]
        e = E3[r if E3.shape[0] > 1 else 0]
        T = (x[:, :, None] <= e[None]).reshape(n, F * B).to(torch.float32)
        stats = _stats_matrix(node2[r], S3[r], n_nodes, hist_dtype)
        with fp32_matmul():
            out[r] = (T.t() @ stats).reshape(F, B, n_nodes, K)
    return out[0] if squeeze else out


def fixed_scales(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each replica's fixed-point scale ``2**s_r`` (float32) and its
    inverse ``2**-s_r`` (float64) for the float statistics ``S (R, n,
    K)``: the largest s_r with ``n · max|S_r| · 2**s_r <= 2**52``, so
    every sum of the table (at most n terms) stays below 2**52, within
    [-100, 100]. ``max |S_r| < 2**e_r`` (``frexp``), and a bfloat16
    rounding of S stays within ``2**e_r`` too. Built from exponent bits,
    so both are exact powers of two on every device."""
    R, n, _ = S.shape
    flat = S.reshape(R, -1)
    if flat.shape[1] == 0:
        amax = torch.zeros(R, dtype=torch.float32, device=S.device)
    else:
        lo, hi = torch.aminmax(flat, dim=1)
        amax = torch.maximum(-lo, hi)
    _, e = torch.frexp(amax)
    shift = (FIXED_SUM_BITS - max(n, 1).bit_length() - e.to(torch.int64))
    shift = shift.clamp(-_FIXED_MAX_SHIFT, _FIXED_MAX_SHIFT)
    scale = ((shift + 127) << 23).to(torch.int32).view(torch.float32)
    inv = ((1023 - shift) << 52).view(torch.float64)
    return scale.contiguous(), inv.contiguous()


def bin_codes_plain(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`bin_codes`: the count of edges
    (NaN read as +inf) below x, one edge at a time, and B for a NaN x."""
    B = edges.shape[-1]
    dt = code_dtype(B)
    X3 = X[None] if X.dim() == 2 else X
    E3 = edges[None] if edges.dim() == 2 else edges
    e_inf = torch.where(torch.isnan(E3), math.inf, E3)[:, None]
    codes = torch.zeros(torch.broadcast_shapes(X3.shape, e_inf.shape[:-1]),
                        dtype=torch.int32, device=X.device)
    for b in range(B):
        codes += X3 > e_inf[..., b]
    codes = torch.where(torch.isnan(X3), B, codes).to(dt)
    return codes[0] if X.dim() == 2 and edges.dim() == 2 else codes


def coded_left_stats_plain(
    codes: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
    cols: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain torch version of :func:`coded_left_stats`: each
    replica's indicator ``[code <= b]`` (0 at NaN edges) read through its
    columns, contracted with the node-scattered statistics as in
    :func:`binned_left_stats_plain`; the same indicator, so the same
    float32 result."""
    R, n, K = S.shape
    C3 = codes[None] if codes.dim() == 2 else codes
    E3 = edges[None] if edges.dim() == 2 else edges
    F, B = E3.shape[-2:]
    bins = torch.arange(B, device=S.device)
    out = torch.empty((R, F, B, n_nodes, K), dtype=torch.float32,
                      device=S.device)
    for r in range(R):
        c = C3[r if C3.shape[0] > 1 else 0]
        if cols is not None:
            c = c[:, cols[r].long()]
        e = E3[r if E3.shape[0] > 1 else 0]
        T = (c[:, :, None] <= bins) & ~torch.isnan(e)[None]
        T = T.reshape(n, F * B).to(torch.float32)
        stats = _stats_matrix(node[r], S[r], n_nodes, hist_dtype)
        with fp32_matmul():
            out[r] = (T.t() @ stats).reshape(F, B, n_nodes, K)
    return out


def coded_left_stats_fixed(
    codes: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
    cols: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain torch version of the kernel's fixed-point accumulator
    (float statistics on the card), on any device, bit for bit: each
    value of replica r becomes the int64 ``rint(v · 2**s_r)``
    (:func:`fixed_scales`), the integers are summed exactly by
    ``index_add_`` into (feature, code, node, k), cumulated over codes,
    and each entry converted once, ``float32(float64(sum) ·
    2**-s_r)``; 0 at NaN edges. The sums are integers, so the table is
    the same in any row order."""
    R, n, K = S.shape
    C3 = codes[None] if codes.dim() == 2 else codes
    E3 = edges[None] if edges.dim() == 2 else edges
    F, B = E3.shape[-2:]
    dev = S.device
    scale, inv = fixed_scales(S)
    out = torch.empty((R, F, B, n_nodes, K), dtype=torch.float32, device=dev)
    for r in range(R):
        c = C3[r if C3.shape[0] > 1 else 0]
        if cols is not None:
            c = c[:, cols[r].long()]
        keep = (node[r] >= 0) & (node[r] < n_nodes)
        s = S[r][keep].to(torch.float32)
        if hist_dtype == "bfloat16":
            s = bf16_round(s)
        q = torch.round(s * scale[r]).to(torch.int64)
        code = c[keep].to(torch.int64).clamp(max=B)  # bin B: none
        flat = ((torch.arange(F, device=dev) * (B + 1) + code) * n_nodes
                + node[r][keep].to(torch.int64)[:, None])
        idx = flat[..., None] * K + torch.arange(K, device=dev)
        table = torch.zeros(F * (B + 1) * n_nodes * K, dtype=torch.int64,
                            device=dev)
        table.index_add_(0, idx.reshape(-1),
                         q[:, None, :].expand(-1, F, -1).reshape(-1))
        table = table.view(F, B + 1, n_nodes, K)[:, :B].cumsum(dim=1)
        nan_e = torch.isnan(E3[r if E3.shape[0] > 1 else 0])
        out[r] = (table.to(torch.float64) * inv[r]).to(
            torch.float32).masked_fill(nan_e[:, :, None, None], 0.0)
    return out


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


def _check_codes_input(X, edges) -> None:
    for name, t in (("X", X), ("edges", edges)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if X.device != edges.device:
        raise ValueError("X and edges must lie on one device")
    if X.dim() not in (2, 3) or edges.dim() not in (2, 3):
        raise ValueError(
            f"expected X (n, F) or (R, n, F) and edges (F, B) or (R, F, B); "
            f"got {tuple(X.shape)}, {tuple(edges.shape)}")
    if X.dim() == edges.dim() == 3 and X.shape[0] != edges.shape[0]:
        raise ValueError(
            f"replica counts disagree: X {X.shape[0]}, edges {edges.shape[0]}")
    if X.shape[-1] != edges.shape[-2]:
        raise ValueError(
            f"X has {X.shape[-1]} features, edges {edges.shape[-2]}")
    if edges.shape[-1] < 1:
        raise ValueError("edges need at least one bin")
    code_dtype(edges.shape[-1])
    if not (X.is_contiguous() and edges.is_contiguous()):
        raise ValueError("X and edges must be contiguous")


def _check_coded(codes, edges, node, S, cols, n_nodes, hist_dtype) -> None:
    if hist_dtype not in _HIST_DTYPES:
        raise ValueError(
            f"hist_dtype must be one of {_HIST_DTYPES}, got {hist_dtype!r}")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    for name, t in (("edges", edges), ("S", S)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if node.dtype != torch.int32:
        raise TypeError(f"node must be int32, got {node.dtype}")
    if cols is not None and cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if codes.dtype != code_dtype(edges.shape[-1]):
        raise TypeError(
            f"codes of {edges.shape[-1]} bins must be "
            f"{code_dtype(edges.shape[-1])}, got {codes.dtype}")
    ts = [t for t in (codes, edges, node, S, cols) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("codes, edges, node, S and cols must lie on one device")
    if S.dim() != 3 or node.dim() != 2 or codes.dim() not in (2, 3) \
            or edges.dim() not in (2, 3) or (cols is not None
                                             and cols.dim() != 2):
        raise ValueError(
            f"expected S (R, n, K), node (R, n), codes (n, F) or (R, n, F), "
            f"edges (F, B) or (R, F, B), cols (R, F); got {tuple(S.shape)}, "
            f"{tuple(node.shape)}, {tuple(codes.shape)}, "
            f"{tuple(edges.shape)}, "
            f"{None if cols is None else tuple(cols.shape)}")
    reps = {S.shape[0], node.shape[0]}
    reps |= {t.shape[0] for t in (codes, edges) if t.dim() == 3}
    if cols is not None:
        reps.add(cols.shape[0])
    if len(reps) > 1:
        raise ValueError(f"replica counts disagree: {sorted(reps)}")
    n = S.shape[1]
    if node.shape[1] != n or codes.shape[-2] != n:
        raise ValueError(
            f"row counts disagree: S {n}, node {node.shape[1]}, "
            f"codes {codes.shape[-2]}")
    F = codes.shape[-1] if cols is None else cols.shape[1]
    if F != edges.shape[-2]:
        raise ValueError(
            f"{F} features ({'codes' if cols is None else 'cols'}), "
            f"edges {edges.shape[-2]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("codes, edges, node, S and cols must be contiguous")


def _pad(f_tile: int) -> int:
    """The bin stride's alignment: the power of two at or above the
    block's feature count, at most 32 (the banks)."""
    return min(32, 1 << (f_tile - 1).bit_length())


def _b_stride(n_tile: int, f_tile: int, K: int) -> int:
    """Words between neighbouring bins of a block's histogram plane
    ``[b][node][k][f]``: its ``n_tile·K·f_tile`` entries rounded up to a
    multiple of :func:`_pad`, so the features one warp adds for one row
    (the same node and k, any bins) fall on distinct banks."""
    p = _pad(f_tile)
    return -(-n_tile * K * f_tile // p) * p


def _block_smem(B: int, n_tile: int, f_tile: int, K: int,
                acc_bytes: int = INT32_BYTES) -> int:
    """Shared bytes of a block: its ``(B + 1, b_stride)`` histogram (bin
    B takes the pairs that add nothing) in one 32-bit plane a 4 bytes of
    accumulator (the fixed point's low and high words), its feature
    columns, its staged items, its row list and six claim counters."""
    return (acc_bytes * (B + 1) * _b_stride(n_tile, f_tile, K)
            + 4 * f_tile + (_ITEM_INDEX_BYTES + acc_bytes) * STAGE_ITEMS
            + 4 * _LIST_ROWS + 24)


def hist_geometry(n: int, F: int, B: int, n_nodes: int, K: int, R: int,
                  n_sm: int, acc_bytes: int = INT32_BYTES,
                  max_split_rows: int | None = None) -> dict:
    """Launch geometry of the histogram kernel for one launch (pure
    arithmetic, so the CPU tests can check it). A block keeps an int32
    (``acc_bytes`` 4) or int64 fixed-point (8: a plane of low and one of
    high 32-bit words) histogram ``[b][node][k][f]`` of ``n_tile``
    nodes and ``f_tile`` features in shared memory, word ``b·b_stride +
    (node·K + k)·f_tile + f`` of each plane: features fastest (stride 1,
    odd) and the bin stride ``b_stride`` a multiple of the power of two
    at or above ``f_tile`` (32 from 32 features on), so the features a
    warp adds for one row fall on distinct banks whatever their bins.
    Beside it sit the block's feature columns, a staging buffer of
    ``cap`` = ``STAGE_ITEMS`` items and a row list. The grid is
    (replica, feature tile x node tile, row split).

    Nodes are tiled before features: every feature for as many nodes
    as fit 72 KB, the node tiles evened out; one node's full-width
    histogram beyond that takes up to 227 KB; beyond that features are
    tiled, one node a block, and a block of a single feature's ``(B,
    K)`` histogram beyond 227 KB refuses the shape (:func:`stat_tiles`
    splits such a table over launches). Rows are split over blocks for
    occupancy, at least ``MIN_SPLIT_ROWS`` a block and at most
    ``max_split_rows`` (the wrapper's ``FIXED_SPLIT_ROWS`` in fixed
    point, for speed: both accumulators are exact in any split)."""

    def smem(n_tile, f_tile):
        return _block_smem(B, n_tile, f_tile, K, acc_bytes)

    if smem(1, F) <= _MAX_SMEM_BYTES:
        f_tile = F
        room = (_SMEM_BYTES - smem(0, F)) // (acc_bytes * (B + 1))
        n_tile = max(1, min(n_nodes, room // _pad(F) * _pad(F) // (K * F)))
    elif smem(1, 1) <= _MAX_SMEM_BYTES:
        n_tile, lo, hi = 1, 1, F  # the most features that fit, by bisection
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if smem(1, mid) <= _MAX_SMEM_BYTES else (lo, mid - 1)
        f_tile = lo
    else:
        raise ValueError(
            f"B={B}, K={K}: one feature's histogram of one node needs "
            f"{smem(1, 1)} bytes of shared memory with its staging, beyond "
            f"the {_MAX_SMEM_BYTES} a block can have; use fewer bins or "
            "split_impl='dense'")
    n_tile = math.ceil(n_nodes / math.ceil(n_nodes / n_tile))
    n_tiles = math.ceil(n_nodes / n_tile)
    f_tile = math.ceil(F / math.ceil(F / f_tile))
    f_tiles = math.ceil(F / f_tile)
    if f_tiles * n_tiles > 65535:  # the grid's y extent
        raise ValueError(f"{f_tiles * n_tiles} feature x node tiles "
                         "(at most 65535)")
    want = max(1, math.ceil(_BLOCKS_PER_SM * n_sm / (R * f_tiles * n_tiles)))
    rows_per_split = max(MIN_SPLIT_ROWS, math.ceil(n / want))
    if max_split_rows is not None:
        rows_per_split = min(rows_per_split, max_split_rows)
    splits = max(1, math.ceil(n / rows_per_split))
    if splits > 65535:  # the grid's z extent
        raise ValueError(f"n={n} rows need {splits} row splits (at most 65535)")
    return dict(f_tile=f_tile, n_tile=n_tile, f_tiles=f_tiles,
                n_tiles=n_tiles, b_stride=_b_stride(n_tile, f_tile, K),
                cap=STAGE_ITEMS, splits=splits, rows_per_split=rows_per_split,
                smem=smem(n_tile, f_tile), threads=_THREADS)


def stat_tiles(B: int, K: int,
               acc_bytes: int = INT32_BYTES) -> list[tuple[int, int, int, int]]:
    """Contiguous ``(b0, b1, k0, k1)`` tiles that cover ``[0, B) x
    [0, K)`` exactly once, each small enough for one launch (pure
    arithmetic). The table is separable along both axes: entry
    ``[f, b, n, k]`` counts ``[code <= b] [node = n] S[k]``, so a launch
    on bins ``[b0, b1)`` that adds a code below b0 into its first bin
    and drops a code at or above b1, with ``S[..., k0:k1]``, computes
    ``out[..., b0:b1, :, k0:k1]``. Classes are split only where one bin
    of all classes does not fit; then bins are split as evenly as fits.
    One tile where the whole ``(B, K)`` slice fits."""
    n_k = 1
    while _block_smem(1, 1, 1, math.ceil(K / n_k),
                      acc_bytes) > _MAX_SMEM_BYTES:
        n_k += 1
    kt = math.ceil(K / n_k)
    stage = _block_smem(0, 1, 1, kt, acc_bytes)
    bt = min(B, (_MAX_SMEM_BYTES - stage) // (acc_bytes * kt))
    n_b = math.ceil(B / bt)
    bt = math.ceil(B / n_b)
    return [(b0, min(B, b0 + bt), k0, min(K, k0 + kt))
            for k0 in range(0, K, kt) for b0 in range(0, B, bt)]


def launch_bytes(F: int, B: int, n_nodes: int, K: int, splits: int = 1,
                 integral: bool = True) -> float:
    """Device bytes one replica adds to a launch of many replicas: its
    ``(F, B, n_nodes, K)`` float32 output and ``splits`` row splits'
    partials: float32 for integral statistics, one split where the
    replicas fill the card (a launch of few replicas splits rows finer,
    but is small); int64 in fixed point, which always has them,
    :func:`fixed_splits` of them."""
    per = 4.0 if integral else FIXED_BYTES
    return (4.0 + per * splits) * F * B * n_nodes * K


def fixed_splits(n: int) -> int:
    """Row splits of a fixed-point launch on ``n`` rows at least
    (``FIXED_SPLIT_ROWS`` a block at most)."""
    return max(1, math.ceil(n / FIXED_SPLIT_ROWS))


def declare(lib) -> None:
    """The signatures of the csrc/binned_left_stats.cu functions called
    here."""
    lib.sbt_bin_codes.restype = I32
    lib.sbt_bin_codes.argtypes = [
        VP, I64, VP, I64, VP,              # X, x_rstride, E, e_rstride, codes
        I64, I32, I32, I32,                # n, F, B, R
        I32, I32, VP,                      # code_bytes, blocks, stream
    ]
    lib.sbt_binned_left_stats.restype = I32
    lib.sbt_binned_left_stats.argtypes = [
        VP, I64, I32, I32, VP,             # codes, c_rstride, c_row, bytes, cols
        VP, I64,                           # edges, e_rstride
        VP, VP, VP, VP,                    # node, S, out, partials
        I32, I32, I32, I32, I32, I32, I32,  # n, F, B, b0, N, K, R
        I32, I32, I32, I32,                # f_tile n_tile f_tiles n_tiles
        I32, I32,                          # b_stride cap
        I32, I32, I32,                     # splits rows_per_split smem
        I32, VP, VP, VP,                   # bf16, scale, inv_scale, stream
    ]


def _launch_codes(X, edges):
    from spark_bagging_tpu_torch.parallel.compat import count_launch

    X3 = X[None] if X.dim() == 2 else X
    E3 = edges[None] if edges.dim() == 2 else edges
    R = max(X3.shape[0], E3.shape[0])
    n, F = X3.shape[1:]
    B = E3.shape[-1]
    dt = code_dtype(B)
    dev = X.device
    out = torch.empty((R, n, F), dtype=dt, device=dev)
    if R > 65535:  # the grid's y extent
        raise ValueError(f"{R} replicas of bin codes (at most 65535)")
    if out.numel():
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = min(math.ceil(n * F / 256), max(1, 32 * n_sm // R))
        lib = kernels.library()
        with torch.cuda.device(dev):
            err = lib.sbt_bin_codes(
                X3.data_ptr(), 0 if X3.shape[0] == 1 else n * F,
                E3.data_ptr(), 0 if E3.shape[0] == 1 else F * B,
                out.data_ptr(), n, F, B, R, out.element_size(), blocks,
                kernels.stream(dev))
        kernels.check(lib, err, "bin_codes")
        count_launch(bin_codes)
    return out[0] if X.dim() == 2 and edges.dim() == 2 else out


def bin_codes(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bin codes of X: ``code[..., i, f]`` is the first b with ``X[i, f]
    <= edges[f, b]`` (NaN edges read as +inf), B where there is none (a
    NaN x, or x above every edge); uint8 for B <= 255, int16 up to
    32,766 bins (more raise). ``(n, F)`` for a 2-D X and edges, else
    ``(R, n, F)``.

    ``bin_codes.launches`` counts kernel launches (CUDA tensors only).
    """
    _check_codes_input(X, edges)
    with profiler_range(CODES_RANGE):
        if X.device.type == "cpu":
            return bin_codes_plain(X, edges)
        if X.device.type != "cuda":
            raise ValueError(f"unsupported device {X.device}")
        return _launch_codes(X, edges)


bin_codes.launches = 0


def _launch_one(C3, cols, E3, node, S3, out, b0, n_nodes, hist_dtype,
                scales):
    """One histogram launch: ``out`` (R, F, B, n_nodes, K) for the bin
    slice starting at ``b0`` of the codes' numbering, from operands whose
    ``(B, K)`` slice fits one block. ``scales``: None for the int32
    accumulator, else :func:`fixed_scales` of the whole statistics (a
    class slice keeps the whole table's scales)."""
    from spark_bagging_tpu_torch.parallel.compat import count_launch

    R, n, K = S3.shape
    F, B = E3.shape[-2:]
    c_row = C3.shape[-1]
    dev = S3.device
    integral = scales is None
    g = hist_geometry(
        n, F, B, n_nodes, K, R,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        acc_bytes=INT32_BYTES if integral else FIXED_BYTES,
        max_split_rows=None if integral else FIXED_SPLIT_ROWS,
    )
    if not integral:
        partials = torch.empty((g["splits"], *out.shape), dtype=torch.int64,
                               device=dev)
    elif g["splits"] > 1:
        partials = torch.empty((g["splits"], *out.shape),
                               dtype=torch.float32, device=dev)
    else:
        partials = out
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.sbt_binned_left_stats(
            C3.data_ptr(), 0 if C3.shape[0] == 1 else n * c_row, c_row,
            C3.element_size(), None if cols is None else cols.data_ptr(),
            E3.data_ptr(), 0 if E3.shape[0] == 1 else F * B,
            node.data_ptr(), S3.data_ptr(), out.data_ptr(),
            partials.data_ptr(), n, F, B, b0, n_nodes, K, R,
            g["f_tile"], g["n_tile"], g["f_tiles"], g["n_tiles"],
            g["b_stride"], g["cap"], g["splits"],
            g["rows_per_split"], g["smem"], int(hist_dtype == "bfloat16"),
            None if integral else scales[0].data_ptr(),
            None if integral else scales[1].data_ptr(), kernels.stream(dev),
        )
    kernels.check(lib, err, "binned_left_stats")
    count_launch(binned_left_stats)
    if not integral:
        count_launch(binned_left_stats, "float_launches")


def _launch(codes, edges, node, S, cols, n_nodes, hist_dtype, integral):
    C3 = codes[None] if codes.dim() == 2 else codes
    E3 = edges[None] if edges.dim() == 2 else edges
    R, n, K = S.shape
    F, B = E3.shape[-2:]
    out = torch.empty((R, F, B, n_nodes, K), dtype=torch.float32,
                      device=S.device)
    if n == 0 or R == 0 or F == 0 or K == 0:
        return out.zero_()
    if n * C3.shape[-1] >= 2**31:  # row offsets into the codes are int32
        raise ValueError(
            f"{n} rows of {C3.shape[-1]} codes exceed 2**31 codes a replica")
    scales = None if integral else fixed_scales(S)
    tiles = stat_tiles(B, K, INT32_BYTES if integral else FIXED_BYTES)
    if len(tiles) == 1:
        _launch_one(C3, cols, E3, node, S, out, 0, n_nodes, hist_dtype,
                    scales)
        return out
    for b0, b1, k0, k1 in tiles:
        part = torch.empty((R, F, b1 - b0, n_nodes, k1 - k0),
                           dtype=torch.float32, device=S.device)
        _launch_one(C3, cols, E3[..., b0:b1].contiguous(), node,
                    S[..., k0:k1].contiguous(), part, b0, n_nodes,
                    hist_dtype, scales)
        out[:, :, b0:b1, :, k0:k1] = part
    return out


def coded_left_stats(
    codes: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
    cols: torch.Tensor | None = None, integral: bool = False,
) -> torch.Tensor:
    """``(R, F, B, n_nodes, K)`` left statistics of one tree level from
    bin codes read through each replica's columns (see the module
    docstring). On the card ``integral=True`` promises integer
    statistics, which the kernel then sums in int32; float statistics
    are summed in fixed point. The CPU ignores it: its float32
    contraction is exact for integer sums below 2**24."""
    _check_coded(codes, edges, node, S, cols, n_nodes, hist_dtype)
    with profiler_range(HIST_RANGE):
        if S.device.type == "cpu":
            return coded_left_stats_plain(codes, edges, node, S,
                                          n_nodes=n_nodes,
                                          hist_dtype=hist_dtype, cols=cols)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        return _launch(codes, edges, node, S, cols, n_nodes, hist_dtype,
                       integral)


def binned_left_stats(
    X: torch.Tensor, edges: torch.Tensor, node: torch.Tensor,
    S: torch.Tensor, *, n_nodes: int, hist_dtype: str = "bfloat16",
) -> torch.Tensor:
    """``(R, F, B, n_nodes, K)`` left statistics of one tree level (see
    the module docstring); ``(F, B, n_nodes, K)`` for the 2-D layout.
    On the card: :func:`bin_codes` of X, then the histogram kernel on
    the codes with identity columns. Statistics are summed in fixed
    point, as float ones are by :func:`coded_left_stats`.

    ``binned_left_stats.launches`` counts the histogram kernel's
    launches (CUDA tensors only, through either entry point).
    """
    _check(X, edges, node, S, n_nodes, hist_dtype)
    with profiler_range(HIST_RANGE):
        if S.device.type == "cpu":
            return binned_left_stats_plain(X, edges, node, S,
                                           n_nodes=n_nodes,
                                           hist_dtype=hist_dtype)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        _, _, node2, S3, squeeze = _as_batched(X, edges, node, S)
        out = _launch(bin_codes(X, edges), edges, node2, S3, None, n_nodes,
                      hist_dtype, False)
        return out[0] if squeeze else out


binned_left_stats.launches = 0
binned_left_stats.float_launches = 0
LAUNCH_COUNTERS = {
    "binned_left_stats": (binned_left_stats, "launches"),
    "binned_left_stats_float": (binned_left_stats, "float_launches"),
    "bin_codes": (bin_codes, "launches"),
}
