"""Depth-bounded decision trees, batched over a leading replica axis.

The port of the JAX package's ``models/tree.py``: every shape is
static, so a whole chunk of replicas grows together.

- **Dense complete binary tree** of depth ``d``: node arrays of length
  ``2^d - 1`` (internal, level by level) and ``2^d`` (leaves). Growth is
  level-synchronous: every node of a level splits at once.
- **Quantile binning, shared across replicas.** ``prepare()`` computes
  per-feature quantile bin edges once per ensemble (the engine hoists it
  out of the replica chunks); a feature subspace gathers its rows.
- **One shared X.** A feature subspace is read through the replica's
  column index ``cols`` (``gather_subspace``), so the engine never
  copies X per replica (``reads_subspace_index``), in the fit or in
  prediction (``predict_scores(..., cols=)``): routing reads
  ``X[i, cols[r, f]]``, the same floats a gathered copy holds.
- **Split search = one left-statistics table per level**:
  ``(R, F, B, N, K)`` weighted class counts (or regression moments) left
  of every candidate threshold. ``split_impl="fused"`` computes it with
  the histogram kernel (ops/hist.py: CUDA on the card) from bin codes
  of the shared X made once at prepare time; ``"dense"`` precomputes
  the 0/1 threshold indicator ``T`` at prepare time and multiplies it
  with the node-scattered statistics. ``"auto"`` takes the kernel on a
  CUDA device, as the JAX package takes its Pallas kernel on a TPU, and
  the dense product on the CPU.
- **Weighted everything**: the Poisson bootstrap counts enter as exact
  per-row weights in the split statistics and the leaf values.

``hist_dtype="bfloat16"`` rounds the statistics to bfloat16 before they
are summed in float32: exact for integer bootstrap counts times one-hot
classes, so classification splits are exact. On the CPU the port sums
in float32 whatever ``hist_dtype`` says, as the JAX package does on its
CPU backend. ``precision`` is kept for parity with the JAX signature;
every product here pins its own precision (ops/precision.py).

``to_debug_string`` renders one replica's tree (Spark's
``toDebugString``). ``_chunk_level_hist`` is the streamed fit's step
(tree_stream.py): one row block's table under the stream's edges.
"""

from __future__ import annotations

import math
from typing import ClassVar

import numpy as np
import torch

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.models.base import BaseLearner
from spark_bagging_tpu_torch.ops import hist as hist_ops
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.ops.reduce import maybe_psum

_EPS = 1e-12
_HIST_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# rows a block of the leaf sums: each block's sums are one float32
# product, the blocks' sums are added in float64. One product over every
# row sums each leaf in one float32 accumulator (cuBLAS's long-K GEMM):
# at 800,000 rows its Newton leaves drift ~2e-3 of a round's largest
# leaf from float64
LEAF_BLOCK_ROWS = 4096


def _leaf_sums(node: torch.Tensor, S: torch.Tensor, n_leaves: int,
               block_rows: int = LEAF_BLOCK_ROWS) -> torch.Tensor:
    """Per-leaf sums ``(R, n_leaves, K)`` of ``S (R, n, K)`` by row
    blocks: the rows padded to whole blocks with no leaf, each block's
    one-hot product in float32, the blocks added in float64 and the sum
    rounded to float32 once (a single block: the one product's bits).
    Integer statistics below 2**24 sum exactly."""
    R, n, K = S.shape
    rows = max(1, min(block_rows, n))
    nb = -(-n // rows)
    pad = nb * rows - n
    if pad:
        node = torch.nn.functional.pad(node, (0, pad), value=n_leaves)
        S = torch.nn.functional.pad(S, (0, 0, 0, pad))
    onehot = (node[..., None] == torch.arange(n_leaves, device=node.device))
    onehot = onehot.to(torch.float32).view(R, nb, rows, n_leaves)
    with fp32_matmul():
        part = onehot.transpose(-1, -2) @ S.reshape(R, nb, rows, K)
    return part.sum(dim=1, dtype=torch.float64).to(torch.float32)


def _check_feature_subset(fs):
    """Validate a featureSubsetStrategy value; returns it unchanged."""
    if fs is None or fs in ("all", "sqrt", "log2", "onethird"):
        return fs
    if isinstance(fs, bool):
        raise ValueError(f"invalid feature_subset {fs!r}")
    if isinstance(fs, int):
        if fs < 1:
            raise ValueError(f"int feature_subset must be >= 1, got {fs}")
        return fs
    if isinstance(fs, float):
        if not 0.0 < fs <= 1.0:
            raise ValueError(
                f"float feature_subset must be in (0, 1], got {fs}"
            )
        return fs
    raise ValueError(
        "feature_subset must be None|'all'|'sqrt'|'log2'|'onethird'|"
        f"float|int, got {fs!r}"
    )


def _quantile_edges(X: torch.Tensor, row_mask, n_bins: int):
    """Per-feature interior bin edges ``(F, n_bins - 1)`` and the valid
    row count: order statistics at positions ``(b+1)/B * n_valid``,
    computed in float32 as the JAX package does. Rows with
    ``row_mask == 0`` are pushed to +inf before the sort; NaN sorts
    last, as in ``jnp.sort``."""
    n = X.shape[0]
    Xt = X.t()
    if row_mask is not None:
        Xt = torch.where(row_mask[None, :] > 0, Xt, math.inf)
        n_valid = (row_mask > 0).sum().to(torch.int32)
    else:
        n_valid = torch.tensor(n, dtype=torch.int32, device=X.device)
    Xs = torch.sort(Xt, dim=1).values  # (F, n)
    pos = (torch.arange(1, n_bins, dtype=torch.float32, device=X.device)
           * (n_valid.to(torch.float32) / n_bins)).to(torch.int32)
    pos = torch.clamp(pos, 0, n - 1)
    return Xs[:, pos.long()], n_valid


def _psum_average_edges(interior: torch.Tensor, n_valid: torch.Tensor,
                        axis_name: str | None) -> torch.Tensor:
    """Masked cross-shard average of quantile edges, as the JAX package
    forms it: shards holding at least one valid row contribute;
    padding-only shards (whose edges are +inf) are left out."""
    if axis_name is None:
        return interior
    has = (n_valid > 0).to(interior.dtype)
    num = maybe_psum(
        torch.where(torch.isfinite(interior), interior,
                    torch.zeros((), dtype=interior.dtype,
                                device=interior.device)) * has,
        axis_name,
    )
    den = torch.clamp_min(maybe_psum(has, axis_name), 1.0)
    return num / den


def _take_feature(X: torch.Tensor, f_row: torch.Tensor,
                  cols: torch.Tensor | None = None) -> torch.Tensor:
    """``X[i, f_row[r, i]]`` per replica: ``(R, n)`` from a shared
    ``(n, F)`` or a per-replica ``(R, n, F)`` X; with ``cols`` ``(R,
    k)``, ``X[i, cols[r, f_row[r, i]]]`` from the shared X."""
    idx = f_row.long()
    if cols is not None:
        idx = cols.long().gather(1, idx)
    if X.dim() == 2:
        return X[torch.arange(X.shape[0], device=X.device), idx]
    return X.gather(2, idx[..., None])[..., 0]


class _TreeBase(BaseLearner):
    """Shared growth engine of the classifier and regressor trees."""

    reads_subspace_index = True
    # the split statistics are integers (counts) for integer weights,
    # summed exactly in int32 by the kernel; else floats
    integral_stats: ClassVar[bool] = False
    # one tree a replica: fit_stream grows it with the multi-pass
    # level-synchronous engine (tree_stream.py)
    tree_streamable: ClassVar[bool] = True

    def __init__(
        self,
        max_depth: int = 5,
        n_bins: int = 32,
        hist_dtype: str = "bfloat16",
        precision: str = "highest",
        split_impl: str = "auto",
        feature_subset: str | float | int | None = None,
        min_info_gain: float = 0.0,
        min_instances_per_node: float = 0.0,
    ):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if n_bins < 2:
            raise ValueError(f"n_bins must be >= 2, got {n_bins}")
        if split_impl not in ("auto", "dense", "fused"):
            raise ValueError(
                f"split_impl must be auto|dense|fused, got {split_impl!r}"
            )
        if hist_dtype not in _HIST_DTYPES:
            raise ValueError(
                f"hist_dtype must be bfloat16|float32, got {hist_dtype!r}"
            )
        _check_feature_subset(feature_subset)
        if min_info_gain < 0:
            raise ValueError(
                f"min_info_gain must be >= 0, got {min_info_gain}"
            )
        if min_instances_per_node < 0:
            raise ValueError(
                "min_instances_per_node must be >= 0, got "
                f"{min_instances_per_node}"
            )
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.hist_dtype = hist_dtype
        self.precision = precision
        self.split_impl = split_impl
        self.feature_subset = feature_subset
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node

    def _n_split_features(self, n_features: int) -> int | None:
        """Candidate features per split (Spark's featureSubsetStrategy):
        each node of each level draws a fresh subset; None keeps every
        feature (a plain decision tree)."""
        fs = _check_feature_subset(self.feature_subset)
        F = n_features
        if fs is None or fs == "all":
            return None
        if fs == "sqrt":
            k = int(np.ceil(np.sqrt(F)))
        elif fs == "log2":
            k = int(np.ceil(np.log2(max(F, 2))))
        elif fs == "onethird":
            k = int(np.ceil(F / 3))
        elif isinstance(fs, float):
            k = int(np.ceil(fs * F))
        else:  # int
            k = fs
        k = max(1, min(int(k), F))
        return None if k == F else k

    @staticmethod
    def _level_feat_mask(keys, level, n_nodes, n_features, k):
        """``(R, N, F)`` mask with exactly k candidate features per node,
        drawn from ``fold_in(key, level)`` of each replica's fit key."""
        rand = prng.uniform(prng.fold_in(keys, level), (n_nodes, n_features))
        kth = torch.sort(rand, dim=-1).values[..., k - 1]
        return rand <= kth[..., None]

    def _resolved_impl(self, device: torch.device | None = None) -> str:
        if self.split_impl != "auto":
            return self.split_impl
        on_cuda = device is not None and device.type == "cuda"
        return "fused" if on_cuda else "dense"

    def _hdt(self, device: torch.device | None) -> str:
        """The statistics' operand type on ``device`` (None: the CPU):
        float32 on the CPU, as the JAX package's CPU backend upgrades its
        bfloat16 products."""
        if device is None or device.type == "cpu":
            return "float32"
        return self.hist_dtype

    # -- prepare hook ---------------------------------------------------

    def prepare(self, X, *, row_mask=None, axis_name=None):
        """Bin edges ``(F, B)`` (last edge +inf) and, for the kernel
        path, the bin codes of X ``(n, F)`` (ops/hist.bin_codes: one
        kernel launch a fit on the card); for the dense path the
        threshold indicator, kept transposed as ``(F, B, n)`` int8 so a
        subspace gathers whole ``(B, n)`` slices. On a data mesh
        (``axis_name``) each shard's quantiles are averaged into one
        binning every shard shares, as in the JAX package."""
        interior, n_valid = _quantile_edges(X, row_mask, self.n_bins)
        interior = _psum_average_edges(interior, n_valid, axis_name)
        F = X.shape[1]
        edges = torch.cat([interior, torch.full(
            (F, 1), math.inf, dtype=X.dtype, device=X.device)], dim=1)
        return self._binned(X, edges.contiguous())

    def _binned(self, X, edges):
        """The prepared state of X under given edges ``(F, B)``: the bin
        codes on the kernel path, the threshold indicator on the dense
        one."""
        if self._resolved_impl(X.device) == "fused":
            return {"edges": edges, "codes": hist_ops.bin_codes(X, edges)}
        T = (X.t()[:, None, :] <= edges[:, :, None]).to(torch.int8)
        return {"edges": edges, "T": T}

    def gather_subspace(self, prepared, idx):
        """Each replica's edges and its column index ``cols`` ``(R,
        k)`` into the shared X and codes; the dense path gathers its
        indicator slices."""
        out = {"edges": prepared["edges"][idx.long()],   # (R, k, B)
               "cols": idx.to(torch.int32).contiguous()}
        if "codes" in prepared:
            out["codes"] = prepared["codes"]             # shared (n, F)
        else:
            out["T"] = prepared["T"][idx.long()]         # (R, k, B, n)
        return out

    def _stats_per_row(self, n_outputs: int) -> int:
        """K, the statistics a row carries: its classes for a
        classification tree, the 3 moments for a regression tree."""
        return n_outputs if self.task == "classification" else 3

    def flops_per_fit(self, n_rows, n_features, n_outputs):
        # per level the split search is one (F·B, n) @ (n, N·K)
        # contraction in the dense form; summed over levels N totals
        # 2^d - 1
        K = self._stats_per_row(n_outputs)
        nodes_total = 2**self.max_depth - 1
        return float(
            2 * n_rows * n_features * self.n_bins * K * nodes_total
        )

    def fit_workset_bytes(self, n_rows, n_features, n_outputs, device=None):
        # per-replica temporaries at the deepest level (N = 2^(d-1)
        # nodes): the (F, B, N, K) f32 table with the kernel's row-split
        # partials (ops/hist.launch_bytes: int64 in the fixed-point
        # accumulator of float statistics, rows split at least every
        # FIXED_SPLIT_ROWS), its `right = total - hist`
        # copy and the impurity and score temporaries of _select_splits;
        # the (n, 2^d) f32 leaf one-hot of _leaf_stats; S and the one-hot
        # labels it is made from; the node, routing and gather vectors;
        # and on the dense path the node-scattered statistics and their
        # one-hot in the operand type.
        K = self._stats_per_row(n_outputs)
        N = 2 ** (self.max_depth - 1)
        table = 4.0 * n_features * self.n_bins * N * K
        splits = 1 if self.integral_stats else hist_ops.fixed_splits(n_rows)
        per = (hist_ops.launch_bytes(n_features, self.n_bins, N, K, splits,
                                     self.integral_stats)
               + 3 * table
               + 4.0 * n_rows * 2**self.max_depth
               + 2 * 4.0 * n_rows * K
               + 32.0 * n_rows)
        if self._resolved_impl(device) == "dense":
            item = _HIST_DTYPES[self._hdt(device)].itemsize
            per += item * n_rows * N * (K + 1)
        return float(per)

    def subspace_gather_bytes(self, n_rows, n_subspace, device=None):
        # no copy of X (reads_subspace_index): the kernel path gathers
        # nothing per replica; the dense path gathers its int8
        # indicator slices and their operand-type copy in _grow.
        if self._resolved_impl(device) == "dense":
            item = _HIST_DTYPES[self._hdt(device)].itemsize
            return (1.0 + item) * n_rows * n_subspace * self.n_bins
        return 0.0

    def prepared_bytes(self, n_rows, n_features, device=None):
        # one copy for the whole fit: the bin codes on the kernel path,
        # the int8 indicator on the dense path
        if self._resolved_impl(device) == "dense":
            return float(n_rows * n_features * self.n_bins)
        item = hist_ops.code_dtype(self.n_bins).itemsize
        return float(item * n_rows * n_features)

    # -- growth ---------------------------------------------------------

    def _select_splits(self, hist, edges, feat_mask=None):
        """One level's split choice from its left-statistics table.

        ``hist`` ``(R, F, B, N, K)``; ``edges`` ``(F, B)`` or
        ``(R, F, B)``; ``feat_mask`` ``(R, N, F)`` (per-split feature
        sampling; masked candidates score +inf). Returns ``(feature,
        threshold, score_sum, gain)`` for the level's N nodes of each
        replica. Candidates with fewer than ``min_instances_per_node``
        weighted rows on a side score +inf; a node whose best decrease
        is under ``min_info_gain`` (or that has no valid candidate)
        becomes a leaf: threshold +inf routes every row left.
        """
        R, F, B, N, _ = hist.shape
        total = hist[:, 0, -1]  # edge B-1 is +inf: the full node's sums
        # each candidate's right side from its own feature's node sums
        # (the JAX package takes feature 0's for every feature: the same
        # for NaN-free X up to summation order). The kernel's float sums
        # run in another order per feature, and a right side empty up to
        # that rounding (s0 = 0, s1 ~ 1e-3) would score s1^2 / 1e-12, far
        # below any real split; a feature's own sums leave it exactly 0
        right = hist[:, :, -1:] - hist
        score = self._impurity(hist) + self._impurity(right)  # (R,F,B,N)
        if feat_mask is not None:
            score = torch.where(feat_mask.transpose(1, 2)[:, :, None, :],
                                score, math.inf)
        if self.min_instances_per_node > 0:
            ok = ((self._row_count(hist) >= self.min_instances_per_node)
                  & (self._row_count(right) >= self.min_instances_per_node))
            score = torch.where(ok, score, math.inf)
        flat = score.reshape(R, F * B, N)
        best = torch.argmin(flat, dim=1)  # (R, N), first minimum
        bf = (best // B).to(torch.int32)
        bb = best % B
        E = edges if edges.dim() == 3 else edges.expand(R, *edges.shape)
        thr = E[torch.arange(R, device=E.device)[:, None], bf.long(), bb]
        child = flat.gather(1, best[:, None, :])[:, 0]
        # per-node impurity decrease: the MDI numerator of
        # feature_importances_
        parent = self._impurity(total)
        gain = torch.clamp_min(parent - child, 0.0)
        keep = torch.isfinite(child) & (gain >= self.min_info_gain)
        thr = torch.where(keep, thr, math.inf)
        gain = torch.where(keep, gain, 0.0)
        child = torch.where(keep, child, parent)
        return bf, thr, child.sum(dim=-1), gain

    def _row_count(self, stats):
        """Weighted row mass per candidate side; regression stats carry
        it in moment 0."""
        return stats[..., 0]

    def _dense_left_stats(self, Tf, Sh, node, N):
        """``(R, F·B, N·K)`` left statistics as products of the
        indicator ``Tf`` (``(F·B, n)`` shared or ``(R, F·B, n)``) with
        the node-scattered statistics, float32 accumulation."""
        R, n, K = Sh.shape
        onehot = (node[..., None] == torch.arange(N, device=node.device))
        stats = (onehot.to(Sh.dtype)[..., None] * Sh[:, :, None, :])
        stats = stats.reshape(R, n, N * K)
        out = torch.empty((R, Tf.shape[-2], N * K), dtype=torch.float32,
                          device=Sh.device)
        with fp32_matmul():
            for r in range(R):
                a = Tf[r] if Tf.dim() == 3 else Tf
                if Sh.dtype == torch.float32:
                    out[r] = a @ stats[r]
                else:  # bf16 operands, float32 result
                    out[r] = torch.mm(a, stats[r], out_dtype=torch.float32)
        return out

    def _grow(self, X, S, prepared, keys=None, integral=False,
              axis_name=None):
        """Level-synchronous growth of R trees; returns (feature,
        threshold, per-node gain, leaf index per row, per-level impurity
        curve), each with a leading replica axis.

        ``X`` ``(n, F)`` shared or ``(R, n, F)``, read through
        ``prepared["cols"]`` where the subspace gave one; ``S`` ``(R, n,
        K)``, the per-row statistics whose left/right sums drive the
        impurity (``integral``: they are integers, which the kernel then
        sums exactly in int32); ``keys`` ``(R, 2)``, the replicas' fit
        keys, seed the per-split feature masks when ``feature_subset``
        is set. On a data mesh each level's table sums over the row
        shards (``axis_name``) before the split search, so every shard
        picks the same splits.
        """
        R, n, K = S.shape
        cols = prepared.get("cols")
        F = X.shape[-1] if cols is None else cols.shape[-1]
        B, d = self.n_bins, self.max_depth
        k_split = self._n_split_features(F)
        if k_split is not None and keys is None:
            raise ValueError(
                "feature_subset per-split sampling needs the replica "
                "fit keys; call fit() rather than _grow() directly"
            )
        X = X.contiguous()
        S = S.contiguous()
        edges = prepared["edges"]
        fused = "codes" in prepared
        hdt = self._hdt(S.device)
        if not fused:
            T = prepared["T"]
            Tf = T.reshape(*T.shape[:-3], F * B, n).to(_HIST_DTYPES[hdt])
            Sh = S.to(_HIST_DTYPES[hdt])
        node = torch.zeros((R, n), dtype=torch.int32, device=S.device)
        feats, thrs, curve, gains = [], [], [], []
        for level in range(d):
            # one level: its histogram, the split search and the routing
            with telemetry.span("tree_level", level=level):
                N = 2**level
                if fused:
                    hist = hist_ops.coded_left_stats(
                        prepared["codes"], edges, node, S, n_nodes=N,
                        hist_dtype=hdt, cols=cols, integral=integral)
                else:
                    hist = self._dense_left_stats(Tf, Sh, node, N)
                hist = maybe_psum(hist, axis_name).reshape(R, F, B, N, K)
                mask = (self._level_feat_mask(keys, level, N, F, k_split)
                        if k_split is not None else None)
                bf, thr, score_sum, gain = self._select_splits(hist, edges,
                                                               mask)
                feats.append(bf)
                thrs.append(thr)
                curve.append(score_sum)
                gains.append(gain)
                f_row = bf.gather(1, node.long())
                t_row = thr.gather(1, node.long())
                x_sel = _take_feature(X, f_row, cols)
                node = node * 2 + (x_sel > t_row).to(torch.int32)
        return (torch.cat(feats, dim=1), torch.cat(thrs, dim=1),
                torch.cat(gains, dim=1), node, torch.stack(curve, dim=1))

    def _chunk_level_hist(self, X, S, edges, node, N, cols=None,
                          integral=False):
        """One row block's left statistics ``(R, F, B, N, K)`` under the
        stream's edges ``(F_all, B)``: the streamed fit's per-chunk step
        (tree_stream.py). ``X`` ``(n, F_all)`` is the block, shared by
        every replica and read through ``cols`` ``(R, F)`` (None: every
        feature); ``node`` ``(R, n)``; ``S`` ``(R, n, K)``. On the kernel
        path the block is binned (ops/hist.bin_codes) and its codes
        histogrammed through ``cols``, so no replica copies it; the
        dense path multiplies the block's threshold indicator."""
        prepared = self._binned(X, edges)
        if cols is not None:
            prepared = self.gather_subspace(prepared, cols)
        hdt = self._hdt(S.device)
        if "codes" in prepared:
            return hist_ops.coded_left_stats(
                prepared["codes"], prepared["edges"], node, S, n_nodes=N,
                hist_dtype=hdt, cols=prepared.get("cols"), integral=integral)
        T = prepared["T"]
        F, B, n = T.shape[-3:]
        Tf = T.reshape(*T.shape[:-3], F * B, n).to(_HIST_DTYPES[hdt])
        hist = self._dense_left_stats(Tf, S.to(_HIST_DTYPES[hdt]), node, N)
        return hist.reshape(S.shape[0], F, B, N, S.shape[-1])

    def _leaf_stats(self, node, S, axis_name=None):
        """Per-leaf statistic sums ``(R, 2^d, K)`` in float32 by row
        blocks (:func:`_leaf_sums`), summed over the row shards on a data
        mesh, inside a ``leaf_stats`` span."""
        with telemetry.span("leaf_stats"):
            return maybe_psum(_leaf_sums(node, S, 2**self.max_depth),
                              axis_name)

    # -- the debug dump -------------------------------------------------

    def _leaf_str(self, params, leaf_idx: int) -> str:
        raise NotImplementedError

    def to_debug_string(self, params, feature_names=None) -> str:
        """Human-readable dump of ONE replica's tree (Spark's
        ``DecisionTree*Model.toDebugString``), from its level-ordered
        node arrays as numpy (``replica_params(i)[0]``). A non-finite
        threshold marks an unsplit node (every row routes left) and is
        rendered as the leaf it effectively is::

            clf.base_learner_.to_debug_string(clf.replica_params(i)[0])
        """
        feat = np.asarray(params["feature"])
        thr = np.asarray(params["threshold"])

        def name(f):
            return (
                feature_names[f] if feature_names is not None
                else f"feature {f}"
            )

        lines: list[str] = []
        # reachable splits only: the empty nodes under an unsplit
        # ancestor keep finite thresholds
        n_splits = 0

        def walk(level: int, rel: int, indent: int) -> None:
            nonlocal n_splits
            pad = " " * indent
            if level == self.max_depth:
                lines.append(pad + self._leaf_str(params, rel))
                return
            node = (2**level - 1) + rel
            if not np.isfinite(thr[node]):
                walk(level + 1, 2 * rel, indent)
                return
            n_splits += 1
            lines.append(
                pad + f"If ({name(int(feat[node]))} <= {thr[node]:.6g})"
            )
            walk(level + 1, 2 * rel, indent + 1)
            lines.append(
                pad + f"Else ({name(int(feat[node]))} > {thr[node]:.6g})"
            )
            walk(level + 1, 2 * rel + 1, indent + 1)

        walk(0, 0, 1)
        header = (
            f"{type(self).__name__} (depth={self.max_depth}, "
            f"splits={n_splits})"
        )
        return "\n".join([header] + lines)

    # -- routing (shared by fit-time and predict-time) ------------------

    def _route(self, params, X, cols=None):
        """Leaf index per row ``(R, n)`` via ``max_depth`` gather-compare
        steps; with ``cols`` ``(R, k)`` the split features are read from
        the shared X through each replica's column index."""
        feature, threshold = params["feature"], params["threshold"]
        R = feature.shape[0]
        rel = torch.zeros((R, X.shape[-2]), dtype=torch.int64,
                          device=feature.device)
        off = 0
        for level in range(self.max_depth):
            N = 2**level
            f_row = feature[:, off:off + N].gather(1, rel)
            t_row = threshold[:, off:off + N].gather(1, rel)
            x_sel = _take_feature(X, f_row, cols)
            rel = rel * 2 + (x_sel > t_row).to(torch.int64)
            off += N
        return rel

    def _impurity(self, stats):
        raise NotImplementedError


class DecisionTreeClassifier(_TreeBase):
    """Weighted-Gini (or entropy), depth-``d`` classification tree.

    Leaves store Laplace-smoothed log class probabilities, so
    ``predict_scores`` feeds soft voting as ``softmax(logp) = p`` and
    hard voting as the leaf's majority class.
    """

    task = "classification"
    integral_stats = True
    tree_leaf_scores = "leaf_logp"

    def __init__(
        self,
        max_depth: int = 5,
        n_bins: int = 32,
        leaf_smoothing: float = 1.0,
        hist_dtype: str = "bfloat16",
        precision: str = "highest",
        split_impl: str = "auto",
        feature_subset: str | float | int | None = None,
        min_info_gain: float = 0.0,
        min_instances_per_node: float = 0.0,
        criterion: str = "gini",
    ):
        super().__init__(
            max_depth, n_bins, hist_dtype, precision, split_impl,
            feature_subset, min_info_gain, min_instances_per_node,
        )
        if criterion not in ("gini", "entropy"):
            raise ValueError(
                f"criterion must be gini|entropy, got {criterion!r}"
            )
        if leaf_smoothing < 0:
            raise ValueError(
                f"leaf_smoothing must be >= 0, got {leaf_smoothing}"
            )
        self.leaf_smoothing = leaf_smoothing
        self.criterion = criterion

    def init_params(self, keys, n_features, n_outputs):
        R, dev = keys.shape[0], keys.device
        M, L = 2**self.max_depth - 1, 2**self.max_depth
        return {
            "feature": torch.zeros((R, M), dtype=torch.int32, device=dev),
            "threshold": torch.zeros((R, M), dtype=torch.float32, device=dev),
            "gain": torch.zeros((R, M), dtype=torch.float32, device=dev),
            "leaf_logp": torch.zeros((R, L, n_outputs), dtype=torch.float32,
                                     device=dev),
        }

    def _impurity(self, stats):
        """Weighted impurity mass per side of class counts ``(..., C)``.
        Gini: ``|side| (1 - sum p^2)``; entropy: ``-sum c log(c / w)``
        in nats."""
        w = stats.sum(-1)
        if self.criterion == "entropy":
            frac = stats / torch.clamp_min(w, _EPS)[..., None]
            return -(stats * torch.log(torch.clamp_min(frac, _EPS))).sum(-1)
        return w - (stats**2).sum(-1) / torch.clamp_min(w, _EPS)

    def _row_count(self, stats):
        return stats.sum(-1)

    def _row_stats(self, y, w, n_outputs):
        """Per-row split statistics: weighted one-hot class counts."""
        onehot = torch.nn.functional.one_hot(y.long(), n_outputs)
        return w[..., None] * onehot.to(torch.float32)

    def _finalize_leaves(self, feature, threshold, gain, counts, curve):
        """Leaf log-probabilities and the report from leaf class counts
        ``(R, L, C)``; an empty leaf predicts the uniform distribution."""
        C = counts.shape[-1]
        a = self.leaf_smoothing
        totals = counts.sum(-1, keepdim=True)
        logp = torch.where(
            totals > 0,
            torch.log((counts + a) / torch.clamp_min(totals + a * C, _EPS)),
            torch.log(torch.tensor(1.0 / C, dtype=torch.float32,
                                   device=counts.device)),
        )
        w_tot = torch.clamp_min(counts.sum(dim=(1, 2)), _EPS)
        leaf_gini = self._impurity(counts).sum(-1)
        new = {"feature": feature, "threshold": threshold,
               "gain": gain.to(torch.float32),
               "leaf_logp": logp.to(torch.float32)}
        return new, {"loss": leaf_gini / w_tot,
                     "loss_curve": curve / w_tot[:, None]}

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        if prepared is None:
            prepared = self.prepare(X, axis_name=axis_name)
        C = params["leaf_logp"].shape[-1]
        w = sample_weight.to(torch.float32)
        S = self._row_stats(y, w, C)
        # bootstrap counts (or 0/1, or unit weights) times one-hot
        # classes are integers, which the kernel sums exactly in int32
        # while a replica's total weight, the bound of every sum, stays
        # well inside it; a fractional sample_weight makes them floats.
        # On a data mesh the shards decide together (their tables sum)
        fractional = torch.ne(w, torch.floor(w)).any().to(torch.float32)
        w_max = maybe_psum(w.sum(-1), axis_name).max()
        integral = bool(maybe_psum(fractional, axis_name) == 0
                        and w_max < 2.0**30)
        feature, threshold, gain, node, curve = self._grow(
            X, S, prepared, keys, integral=integral, axis_name=axis_name
        )
        counts = self._leaf_stats(node, S, axis_name)  # (R, L, C)
        return self._finalize_leaves(feature, threshold, gain, counts, curve)

    def predict_scores(self, params, X, cols=None):
        logp = params["leaf_logp"]
        leaf = self._route(params, X, cols)
        return logp.gather(1, leaf[..., None].expand(-1, -1, logp.shape[-1]))

    def _leaf_str(self, params, leaf_idx):
        logp = np.asarray(params["leaf_logp"][leaf_idx])
        c = int(logp.argmax())
        return f"Predict: {c} (p={float(np.exp(logp[c])):.3f})"


class DecisionTreeRegressor(_TreeBase):
    """Weighted-variance (SSE) regression tree.

    Leaves store the weighted mean target; empty leaves fall back to
    the global weighted mean (only out-of-bag rows can reach them).
    """

    task = "regression"

    def init_params(self, keys, n_features, n_outputs):
        R, dev = keys.shape[0], keys.device
        M, L = 2**self.max_depth - 1, 2**self.max_depth
        return {
            "feature": torch.zeros((R, M), dtype=torch.int32, device=dev),
            "threshold": torch.zeros((R, M), dtype=torch.float32, device=dev),
            "gain": torch.zeros((R, M), dtype=torch.float32, device=dev),
            "leaf_value": torch.zeros((R, L), dtype=torch.float32,
                                      device=dev),
        }

    def _impurity(self, stats):
        """Weighted SSE ``sum w y^2 - (sum w y)^2 / sum w`` per side of
        moment sums ``(..., 3)`` of (w, w y, w y^2)."""
        s0, s1, s2 = stats[..., 0], stats[..., 1], stats[..., 2]
        return s2 - s1**2 / torch.clamp_min(s0, _EPS)

    def _row_stats(self, y, w, n_outputs):
        """Per-row split statistics: weighted moments (w, w y, w y^2)."""
        yf = y.to(torch.float32)
        return torch.stack([w, w * yf, w * yf**2], dim=-1)

    def _finalize_leaves(self, feature, threshold, gain, m, curve):
        """Leaf means and the report from leaf moment sums ``(R, L, 3)``."""
        w_tot = torch.clamp_min(m[..., 0].sum(-1), _EPS)
        global_mean = m[..., 1].sum(-1) / w_tot
        value = torch.where(
            m[..., 0] > 0,
            m[..., 1] / torch.clamp_min(m[..., 0], _EPS),
            global_mean[:, None],
        )
        sse = self._impurity(m).sum(-1)
        new = {"feature": feature, "threshold": threshold,
               "gain": gain.to(torch.float32),
               "leaf_value": value.to(torch.float32)}
        return new, {"loss": sse / w_tot, "loss_curve": curve / w_tot[:, None]}

    def fit(self, params, X, y, sample_weight, keys, *, prepared=None,
            axis_name=None):
        del params
        if prepared is None:
            prepared = self.prepare(X, axis_name=axis_name)
        S = self._row_stats(y, sample_weight.to(torch.float32), 1)
        feature, threshold, gain, node, curve = self._grow(
            X, S, prepared, keys, axis_name=axis_name
        )
        m = self._leaf_stats(node, S, axis_name)  # (R, L, 3)
        return self._finalize_leaves(feature, threshold, gain, m, curve)

    def predict_scores(self, params, X, cols=None):
        return params["leaf_value"].gather(1, self._route(params, X, cols))

    def _leaf_str(self, params, leaf_idx):
        return f"Predict: {float(params['leaf_value'][leaf_idx]):.6g}"
