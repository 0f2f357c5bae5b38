"""The replica-summed soft vote of linear-softmax learners:
``sum_r softmax([X, 1] @ W[r])``, ``(n, C)``.

A learner whose scores are ``augment_bias(X) @ W`` with ``W (R, d+1,
C)`` (``BaseLearner.linear_softmax_weights``, the logistic learner)
votes softly on the card by one pass over X: :func:`soft_vote_quanta`
launches the Hopper kernel of ``csrc/soft_vote.cu``; the ``(R, n, C)``
scores stay on chip, the bias row of W is added in the kernel, and only
the ``(n, C)`` sums are written. :func:`soft_vote_mean` turns the sums
of one or more launches (replica chunks, mesh shards) into the mean
probabilities. :func:`soft_vote_sums_plain` is the torch chain the
kernel replaces, its reference in the tests; the engine's CPU path
(``ensemble.predict_ensemble_classifier``) keeps that chain.

Precision: fp32-accurate. The kernel multiplies on the tensor cores as
3xTF32 (each fp32 operand split into a TF32 part rounded to nearest and
its rest; each product within ``2**-20`` of its size; W scaled by
log2(e) as it is split) and takes each replica's softmax in fp32
(``ex2`` of base-2 scores, an approximate reciprocal). Each replica's
probability then enters the sums in fixed point, within 2**-47: two
int64 words, whole quanta of ``HI_QUANTUM`` (2**-22) and a rest in
quanta of ``LO_QUANTUM`` (2**-68), which keeps fp32's relative
precision down to probabilities of ~1e-13. Integer sums are exact, so
every path of one bag (chunks, launches, mesh shards) gives the same
bits; the means differ from the plain version's fp32 chain by ~1e-7 a
probability.

Classes and replicas: the kernel takes ``C <= MAX_CLASSES`` and bags of
at most ``MAX_REPLICAS`` (the low word's sums stay within int64); any
other keeps the torch chain (:func:`kernel_applies`).
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.models.base import augment_bias
from spark_bagging_tpu_torch.ops import kernels
from spark_bagging_tpu_torch.ops.kernels import I32, VP
from spark_bagging_tpu_torch.ops.precision import fp32_matmul
from spark_bagging_tpu_torch.ops.reduce import maybe_psum
from spark_bagging_tpu_torch.ops.ranges import profiler_range

# The kernel's compile-time tiling, decided here only: ops/kernels.py
# passes these to nvcc as -D defines, and csrc/soft_vote.cu refuses to
# build without them. A stage holds a KBLOCK-column block of X (bias
# column included) and PAIRS (replica, n8 class tile) pairs of W, the
# n = 8 PAIRS of its wgmma. A block is one warpgroup over ROWS rows.
CUDA_DEFINES = {
    "SBT_SV_KBLOCK": 56,
    "SBT_SV_PAIRS": 8,
}
ROWS = 64
_KBLOCK = CUDA_DEFINES["SBT_SV_KBLOCK"]
_PAIRS = CUDA_DEFINES["SBT_SV_PAIRS"]
# 16-byte units of a stage's split W image, each of its two halves
_STAGE_UNITS = _KBLOCK // 8 * _PAIRS * 16
#: the widest class count the kernel takes: four n8 tiles a replica
MAX_CLASSES = 32
# blocks a launch aims for, per streaming multiprocessor: a launch over
# few rows splits the replicas over grid.y to reach it
_BLOCKS_PER_SM = 3
_MAX_GRID_Y = 65535
#: the quanta of the sums' two words (csrc/soft_vote.cu kQuanta, kRest):
#: a replica's probability is a whole number of HI_QUANTUM and a rest in
#: whole LO_QUANTUM
HI_QUANTUM = 2.0 ** -22
LO_QUANTUM = 2.0 ** -68
#: the largest bag the kernel sums: each replica adds less than 2**46 to
#: the low word, whose int64 sum stays below 2**63 up to here
MAX_REPLICAS = 2 ** 17
#: the profiler range around every launch, whatever implements it (the
#: kernel's launches and the sum of its splits' partials)
SOFT_VOTE_RANGE = "soft_vote"


def kernel_applies(X, W, n_classes: int, n_total: int) -> bool:
    """Does the kernel take this vote: CUDA float32 X and W, at most
    ``MAX_CLASSES`` classes and a bag of at most ``MAX_REPLICAS``?"""
    return (X.device.type == "cuda" and X.dtype == torch.float32
            and W.dtype == torch.float32 and n_classes <= MAX_CLASSES
            and n_total <= MAX_REPLICAS)


def soft_vote_sums_plain(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The plain torch version, the chain the kernel replaces: the
    ``(R, n, C)`` scores ``augment_bias(X) @ W`` in fp32 (TF32 off),
    their softmax, summed over replicas."""
    with fp32_matmul():
        scores = augment_bias(X.to(torch.float32)) @ W
    return torch.softmax(scores, dim=-1).sum(dim=0)


def kernel_geometry(n: int, d: int, C: int, R: int, n_sm: int) -> dict:
    """Launch geometry of the CUDA kernel (pure arithmetic, so the CPU
    tests can check it).

    ``nt`` n8 class tiles a replica and ``nr`` replicas a stage (a
    group); ``kp``, d + 1 rounded up to k8 steps, in ``nkb`` k blocks of
    at most ``KBLOCK`` columns (one block: the X tile stays resident).
    The grid is (``row_tiles`` of ``ROWS`` rows, ``splits``): each split
    takes ``gps`` consecutive groups, as many splits as needed to launch
    ``_BLOCKS_PER_SM`` blocks an SM, and writes its own partial."""
    if not 1 <= C <= MAX_CLASSES:
        raise ValueError(f"C={C} classes: the kernel takes 1 to {MAX_CLASSES}")
    nt = math.ceil(C / 8)
    nr = max(1, _PAIRS // nt)
    kp = 8 * math.ceil((d + 1) / 8)
    nkb = math.ceil(kp / _KBLOCK)
    row_tiles = math.ceil(n / ROWS)
    groups = math.ceil(R / nr)
    want = max(1, math.ceil(_BLOCKS_PER_SM * n_sm / max(row_tiles, 1)))
    gps = math.ceil(groups / min(want, groups, _MAX_GRID_Y))
    splits = math.ceil(groups / gps)
    return dict(nt=nt, nr=nr, kp=kp, nkb=nkb, row_tiles=row_tiles,
                groups=groups, gps=gps, splits=splits)


def _check(X: torch.Tensor, W: torch.Tensor) -> None:
    if X.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"X and W must be float32, got {X.dtype}, {W.dtype}")
    if X.device != W.device:
        raise ValueError(f"X on {X.device} but W on {W.device}")
    if X.dim() != 2 or W.dim() != 3 or W.shape[1] != X.shape[1] + 1:
        raise ValueError(f"X must be (n, d) and W (R, d + 1, C), got "
                         f"{tuple(X.shape)}, {tuple(W.shape)}")


def declare(lib) -> None:
    """The signatures of the csrc/soft_vote.cu functions called here
    (the init through ``kernels.ready``; the stage units by the card
    tests)."""
    lib.sbt_soft_vote.restype = I32
    lib.sbt_soft_vote.argtypes = [
        VP, VP, VP, VP,                    # X, W, split images, out
        I32, I32, I32, I32,                # n, d, C, R
        I32, I32, I32, VP,                 # nkb, gps, splits, stream
    ]
    lib.sbt_soft_vote_init.restype = I32
    lib.sbt_soft_vote_init.argtypes = []
    lib.sbt_soft_vote_stage_units.restype = I32
    lib.sbt_soft_vote_stage_units.argtypes = []


def _launch(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The two launches on CUDA tensors (the body of the operator): the
    sums in fixed point, ``(n, C, 2)`` int64."""
    from spark_bagging_tpu_torch.parallel.compat import count_launch

    n, d = X.shape
    R, _, C = W.shape
    dev = X.device
    if C > MAX_CLASSES:
        raise ValueError(f"C={C} classes: the kernel takes at most "
                         f"{MAX_CLASSES}")
    if R > MAX_REPLICAS:
        raise ValueError(f"R={R} replicas: the kernel sums at most "
                         f"{MAX_REPLICAS}")
    if n == 0 or R == 0:
        return torch.zeros((n, C, 2), dtype=torch.int64, device=dev)
    X, W = X.contiguous(), W.contiguous()
    g = kernel_geometry(
        n, d, C, R, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = kernels.ready(dev, "soft_vote")
    # one allocation: the splits' partials (two words an entry), then the
    # stages' split W images that the first launch writes (both 16-byte
    # aligned)
    n_out = g["splits"] * n * C * 2
    buf = torch.empty(n_out + g["groups"] * g["nkb"] * 2 * _STAGE_UNITS * 2,
                      dtype=torch.int64, device=dev)
    out = buf[:n_out].view(g["splits"], n, C, 2)
    with torch.cuda.device(dev):
        err = lib.sbt_soft_vote(
            X.data_ptr(), W.data_ptr(), buf[n_out:].data_ptr(),
            out.data_ptr(), n, d, C, R, g["nkb"], g["gps"], g["splits"],
            kernels.stream(dev),
        )
    kernels.check(lib, err, "soft_vote")
    count_launch(soft_vote_quanta)
    return out[0] if g["splits"] == 1 else out.sum(dim=0)


def _flops(x_shape, w_shape, out_shape=None, **kwargs) -> int:
    """The scores' products, as ``torch.utils.flop_counter`` counts the
    batched matmul of the plain version: ``2 n R (d + 1) C``."""
    R, d1, C = w_shape
    return 2 * x_shape[0] * R * d1 * C


def _meta(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return X.new_empty((X.shape[0], W.shape[2], 2), dtype=torch.int64)


def soft_vote_quanta(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``(n, C, 2)`` int64, on the card: the softmax of ``[X, 1] @ W[r]``
    summed over the replicas ``r`` of ``W (R, d + 1, C)`` (the bias in
    W's last row) in fixed point, ``[..., 0]`` in quanta of
    ``HI_QUANTUM`` and ``[..., 1]`` of ``LO_QUANTUM``. The sums over any
    partition of the replicas add up to the same integers, so a bag's
    probabilities have the same bits however its replicas are chunked
    or sharded. :func:`soft_vote_mean` makes them probabilities.

    ``soft_vote_quanta.launches`` counts kernel launches."""
    _check(X, W)
    if X.device.type != "cuda":
        raise ValueError(f"the quanta are the kernel's; got {X.device}")
    with profiler_range(SOFT_VOTE_RANGE):
        # the torch operator sbt::soft_vote_quanta: a FlopCounterMode
        # counts its products as the plain version's matmul
        return kernels.operator(
            "soft_vote_quanta", "(Tensor X, Tensor W) -> Tensor", _launch,
            _meta, _flops)(X, W)


soft_vote_quanta.launches = 0
LAUNCH_COUNTERS = {"soft_vote": (soft_vote_quanta, "launches")}


def soft_vote_mean(quanta: torch.Tensor, *, n_total: int,
                   axis_name: str | None = None) -> torch.Tensor:
    """The mean probabilities ``(n, C)`` float32 of a bag of ``n_total``
    replicas from the :func:`soft_vote_quanta` of its parts, ``(P, n, C,
    2)``: the parts (and ``axis_name``'s shards, where it is set) summed
    as integers, exactly, then the two words in float32 over
    ``n_total``."""
    total = maybe_psum(quanta.sum(dim=0), axis_name)
    sums = (total[..., 0].to(torch.float32) * HI_QUANTUM
            + total[..., 1].to(torch.float32) * LO_QUANTUM)
    return sums / n_total
