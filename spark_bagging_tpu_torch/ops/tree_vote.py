"""The replica-summed hard vote of a bag of decision-tree classifiers:
``counts[i, c]``, how many trees route row ``i`` to a leaf whose class
is ``c``, ``(n, C)``.

A learner whose scores are the log-probabilities of the leaf its heap
of ``max_depth`` splits routes a row to (``BaseLearner.tree_leaf_scores``,
the decision-tree classifier) votes hard on the card by one pass over
X: :func:`tree_vote_counts` launches the Hopper kernel of
``csrc/tree_vote.cu``, which routes every row through every tree and
tallies the votes on chip, writing only the ``(n, C)`` counts. No ``(R,
n)`` leaf index, gathered score or one-hot is ever made, so no replica
chunk bounds its memory. :func:`tree_vote_counts_plain` is the torch
chain the kernel replaces (route, gather the leaf's log-probabilities,
argmax, one-hot sum), its reference in the tests; the engine's CPU path
(``ensemble.predict_ensemble_classifier``) keeps that chain.

Before the launch the wrapper makes two small tables in torch on the
device (no host sync, no data-dependent shape, so a CUDA graph captures
them): each node's global column and float32 threshold, and each leaf's
class, ``leaf_logp.argmax(-1)``. The argmax of a gathered leaf row is
the argmax of that leaf's row, so the class keeps torch's rules (the
lowest class of a tie, a NaN's class) by construction.

Exact: every row takes the same comparisons ``x > t`` as the chain (a
NaN goes left; infinities compare as IEEE numbers), and the counts are
whole numbers, exact in float32 up to ``MAX_REPLICAS``, so the result
has the chain's bits, however the replicas are split into launches or
mesh shards. A vote the kernel does not take (:func:`kernel_applies`)
keeps the torch chain.
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.ops import kernels
from spark_bagging_tpu_torch.ops.aggregate import hard_vote_counts
from spark_bagging_tpu_torch.ops.kernels import I32, VP
from spark_bagging_tpu_torch.ops.ranges import profiler_range

# The kernel's compile-time tiling, decided here only: ops/kernels.py
# passes these to nvcc as -D defines, and csrc/tree_vote.cu refuses to
# build without them. A block is WARPS warps over a tile of ROWS rows
# (ROWS / 32 warps of rows times WARPS / (ROWS / 32) groups of trees);
# each thread walks TREES trees side by side.
CUDA_DEFINES = {
    "SBT_TV_ROWS": 128,
    "SBT_TV_WARPS": 32,
    "SBT_TV_TREES": 4,
    "SBT_TV_SMEM": 232_448,
}
ROWS = CUDA_DEFINES["SBT_TV_ROWS"]
#: dynamic shared memory a block may take (an H100's 227 KB)
SMEM_BYTES = CUDA_DEFINES["SBT_TV_SMEM"]
# X's double-buffered row tiles are staged in shared memory where they
# take at most half of it (F <= 113 at 128 rows); wider X is read from
# device memory through the L1 cache
_X_STAGE_BYTES = SMEM_BYTES // 2
#: the deepest tree the kernel walks: a stage then holds at least two
#: trees beside the widest staged X tiles and the widest counts
MAX_DEPTH = 12
#: the widest class count: four 64-bit words of 8-bit counters a thread
MAX_CLASSES = 32
#: the largest bag: its counts stay whole numbers in float32
MAX_REPLICAS = 2 ** 24
#: the profiler range around every launch and the wrapper's tables
TREE_VOTE_RANGE = "tree_vote"


def kernel_applies(X, threshold, depth: int, n_classes: int,
                   n_total: int) -> bool:
    """Does the kernel take this vote: CUDA float32 X and thresholds, a
    depth of at most ``MAX_DEPTH``, at most ``MAX_CLASSES`` classes and a
    bag of at most ``MAX_REPLICAS``?"""
    return (X.device.type == "cuda" and X.dtype == torch.float32
            and threshold.dtype == torch.float32 and depth <= MAX_DEPTH
            and n_classes <= MAX_CLASSES and n_total <= MAX_REPLICAS)


def tree_vote_counts_plain(learner, params: dict, X: torch.Tensor,
                           n_classes: int,
                           cols: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version, the chain the kernel replaces: each
    replica's routed leaf scores (``learner.predict_scores``), their
    argmax, the one-hot votes summed over replicas, ``(n, C)``
    float32."""
    scores = learner.predict_scores(params, X, cols)
    return hard_vote_counts(scores.argmax(dim=-1), n_classes)


def tree_tables(feature: torch.Tensor, threshold: torch.Tensor,
                leaf_logp: torch.Tensor, depth: int,
                cols: torch.Tensor | None = None):
    """The kernel's tables, on the parameters' device: ``nodes (R, 2^D -
    1, 2)`` int32, each node's global column (``cols`` gathered at its
    feature, or the feature under the identity subspace) beside its
    threshold's float32 bits, in heap order; ``leaf (R, 2^D)`` uint8,
    each leaf's class (``leaf_logp.argmax(-1)``)."""
    M = 2 ** depth - 1
    col = feature[:, :M].long()
    if cols is not None:
        col = cols.long().gather(1, col)
    thr = threshold[:, :M].view(torch.int32)
    nodes = torch.stack([col.to(torch.int32), thr], dim=-1)
    return nodes, leaf_logp[:, :M + 1].argmax(dim=-1).to(torch.uint8)


def kernel_geometry(n: int, F: int, C: int, R: int, depth: int,
                    n_sm: int) -> dict:
    """Launch geometry of the CUDA kernel (pure arithmetic, so the CPU
    tests can check it).

    Shared memory holds the tile's counts (``ROWS x C`` int32), X's two
    row tiles where ``staged`` (column-major, ``2 x ROWS x F`` float32)
    and one stage of ``per_stage`` trees' tables (8 bytes a node, a byte
    a leaf). The grid is (``blocks`` persistent blocks walking the
    ``row_tiles``, a block an SM, ``stages``): a bag too large for one
    stage splits its trees over grid.y, and the stages' counts are added
    (``accumulate``)."""
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth}: the kernel walks 1 to "
                         f"{MAX_DEPTH} levels")
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"C={C} classes: the kernel takes 1 to {MAX_CLASSES}")
    M, L = 2 ** depth - 1, 2 ** depth
    cnt = ROWS * C * 4
    staged = 2 * ROWS * F * 4 <= _X_STAGE_BYTES
    x_bytes = 2 * ROWS * F * 4 if staged else 0
    tree_bytes = 8 * M + L
    fit = (SMEM_BYTES - cnt - x_bytes) // tree_bytes
    row_tiles = math.ceil(n / ROWS)
    stages = math.ceil(R / min(R, fit))
    per_stage = math.ceil(R / stages)
    stages = math.ceil(R / per_stage)
    blocks = max(1, min(row_tiles, math.ceil(n_sm / stages)))
    smem = cnt + x_bytes + per_stage * tree_bytes
    return dict(staged=staged, per_stage=per_stage, stages=stages,
                row_tiles=row_tiles, blocks=blocks, smem=smem,
                accumulate=stages > 1)


def _check(X, feature, threshold, leaf_logp, depth, n_classes, cols):
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")
    if X.dim() != 2:
        raise ValueError(f"X must be (n, F), got {tuple(X.shape)}")
    R = feature.shape[0]
    M, L = 2 ** depth - 1, 2 ** depth
    if (feature.dim() != 2 or feature.shape[1] < M
            or tuple(threshold.shape) != tuple(feature.shape)
            or leaf_logp.dim() != 3 or leaf_logp.shape[0] != R
            or leaf_logp.shape[1] < L or leaf_logp.shape[2] != n_classes):
        raise ValueError(
            f"a bag of depth-{depth} trees of {n_classes} classes needs "
            f"feature and threshold (R, >= {M}) and leaf_logp (R, >= {L}, "
            f"{n_classes}), got {tuple(feature.shape)}, "
            f"{tuple(threshold.shape)}, {tuple(leaf_logp.shape)}")
    if threshold.dtype != torch.float32:
        raise TypeError(f"thresholds must be float32, got {threshold.dtype}")
    if cols is not None and (cols.dim() != 2 or cols.shape[0] != R):
        raise ValueError(f"cols must be (R, k), got {tuple(cols.shape)}")
    for t in (feature, threshold, leaf_logp,
              *(() if cols is None else (cols,))):
        if t.device != X.device:
            raise ValueError(f"X on {X.device} but a table on {t.device}")


def declare(lib) -> None:
    """The signatures of the csrc/tree_vote.cu functions called here
    (the init through ``kernels.ready``)."""
    lib.sbt_tree_vote.restype = I32
    lib.sbt_tree_vote.argtypes = [
        VP, VP, VP, VP,                    # X, nodes, leaf, out
        I32, I32, I32, I32, I32,           # n, F, C, R, D
        I32, I32, I32,                     # per_stage, stages, blocks
        I32, I32, I32, VP,                 # staged, accumulate, smem, stream
    ]
    lib.sbt_tree_vote_init.restype = I32
    lib.sbt_tree_vote_init.argtypes = []


def _launch(X: torch.Tensor, nodes: torch.Tensor, leaf: torch.Tensor,
            n_classes: int) -> torch.Tensor:
    """The launch on CUDA tensors (the body of the operator): the
    counts, ``(n, C)`` float32."""
    from spark_bagging_tpu_torch.parallel.compat import count_launch

    n, F = X.shape
    R, M, _ = nodes.shape
    depth = int(math.log2(M + 1))
    dev = X.device
    if R > MAX_REPLICAS:
        raise ValueError(f"R={R} trees: the kernel counts at most "
                         f"{MAX_REPLICAS}")
    if n == 0 or R == 0:
        return torch.zeros((n, n_classes), dtype=torch.float32, device=dev)
    X = X.contiguous()
    g = kernel_geometry(
        n, F, n_classes, R, depth,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = kernels.ready(dev, "tree_vote")
    out = (torch.zeros if g["accumulate"] else torch.empty)(
        (n, n_classes), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.sbt_tree_vote(
            X.data_ptr(), nodes.data_ptr(), leaf.data_ptr(), out.data_ptr(),
            n, F, n_classes, R, depth, g["per_stage"], g["stages"],
            g["blocks"], int(g["staged"]), int(g["accumulate"]), g["smem"],
            kernels.stream(dev),
        )
    kernels.check(lib, err, "tree_vote")
    count_launch(tree_vote_counts)
    return out


def _meta(X: torch.Tensor, nodes: torch.Tensor, leaf: torch.Tensor,
          n_classes: int) -> torch.Tensor:
    return X.new_empty((X.shape[0], n_classes))


def tree_vote_counts(X: torch.Tensor, feature: torch.Tensor,
                     threshold: torch.Tensor, leaf_logp: torch.Tensor, *,
                     depth: int, n_classes: int,
                     cols: torch.Tensor | None = None) -> torch.Tensor:
    """``(n, C)`` float32, on the card: for each row and class, how many
    of the depth-``depth`` trees (``feature``, ``threshold`` ``(R, 2^D -
    1)`` in heap order, ``leaf_logp`` ``(R, 2^D, C)``) route the row to a
    leaf whose argmax class is that class. With ``cols`` ``(R, k)``, a
    tree's features index its columns of the shared X. The same bits as
    :func:`tree_vote_counts_plain`.

    ``tree_vote_counts.launches`` counts kernel launches."""
    _check(X, feature, threshold, leaf_logp, depth, n_classes, cols)
    if X.device.type != "cuda":
        raise ValueError(f"the counts are the kernel's; got {X.device}")
    if not 1 <= depth <= MAX_DEPTH or not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"depth {depth}, {n_classes} classes: the kernel "
                         f"takes depths 1 to {MAX_DEPTH} and 1 to "
                         f"{MAX_CLASSES} classes")
    with profiler_range(TREE_VOTE_RANGE):
        nodes, leaf = tree_tables(feature, threshold, leaf_logp, depth, cols)
        # the torch operator sbt::tree_vote_counts: it counts no FLOPs,
        # as the chain's gathers and compares count none
        return kernels.operator(
            "tree_vote_counts",
            "(Tensor X, Tensor nodes, Tensor leaf, int n_classes) -> Tensor",
            _launch, _meta)(X, nodes, leaf, n_classes)


tree_vote_counts.launches = 0
LAUNCH_COUNTERS = {"tree_vote": (tree_vote_counts, "launches")}
