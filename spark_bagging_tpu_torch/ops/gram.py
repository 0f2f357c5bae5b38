"""Scaled Gram matrices ``X^T diag(S[:, p]) X``: the Newton Hessian kernel.

The Newton Hessian of multinomial logistic regression is P = C(C+1)/2
scaled Grams sharing one X (models/logistic.py). ``scaled_grams``
computes them all in one pass: on a CUDA tensor it launches the Hopper
kernel of ``csrc/scaled_gram.cu``; on a CPU tensor it computes
:func:`scaled_grams_plain`, the same function in plain torch. A CUDA
tensor never takes the plain path: the kernel launches or the call
raises.

The signature is replica-batched: ``X (n, d)`` shared by every replica
(or ``(R, n, d)``, one per replica) and ``S (R, n, P)`` give
``(R, P, d, d)``; a 2-D ``S`` gives ``(P, d, d)``, the JAX package's
single-replica signature.

``op_dtype`` is the operand mode: ``"float32"`` multiplies fp32
operands to fp32 accuracy; ``"bfloat16"`` rounds X and the scaled
operand ``x * s`` (the fp32 product, rounded once) to bfloat16 and
multiplies and sums them in fp32.

The kernel runs on the tensor cores (``mma.sync``). In ``"float32"``
mode it uses 3xTF32: each fp32 operand ``a`` (x, and the fp32 product
``x * s``) is split into ``a_big``, ``a`` cut to TF32's 11 significant
bits, and ``a_small = a - a_big`` (exact in fp32, read by the tensor core
cut to TF32 in turn), and a product is taken as ``a_small*b_big +
a_big*b_small + a_big*b_big``. The cuts and the dropped
``a_small*b_small`` leave a product off by less than ``3 * 2**-20`` of
its size, against fp32's ``2**-24`` rounding: the sums stay well inside
the error scale the tests hold them to (per entry, 1.5e-5 of its
absolute sum). Operands with at most 11 significant bits have
``a_small = 0`` and give exact products. Each 64-row tile is summed in
MMA accumulators from zero and then added into fp32 registers rounding
to nearest: the tensor cores' own accumulation does not round to
nearest, and over a block's 16,384 rows its error grew past that scale
on an H100.
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.ops import kernels
from spark_bagging_tpu_torch.ops.kernels import I32, I64, VP
from spark_bagging_tpu_torch.ops.precision import bf16_round, fp32_matmul
from spark_bagging_tpu_torch.ops.ranges import profiler_range

_OP_DTYPES = ("float32", "bfloat16")
# The kernel's compile-time tiling, decided here only: ops/kernels.py
# passes these to nvcc as -D defines, and csrc/scaled_gram.cu refuses to
# build without them. A block has WARPS warps, each keeping one
# (replica, pair)'s output tile; output tiles are TILE x TILE; a pipeline
# stage holds ROW_TILE rows of X, and each row tile's MMA sum is promoted
# into round-to-nearest fp32 registers.
CUDA_DEFINES = {
    "SBT_GRAM_WARPS": 8,
    "SBT_GRAM_TILE": 64,
    "SBT_GRAM_ROW_TILE": 64,
}
_WARPS = CUDA_DEFINES["SBT_GRAM_WARPS"]
_TILE = CUDA_DEFINES["SBT_GRAM_TILE"]
_ROW_TILE = CUDA_DEFINES["SBT_GRAM_ROW_TILE"]
# blocks the row split aims for, per streaming multiprocessor (one block
# is resident on an SM: its accumulators take most of the registers)
_BLOCKS_PER_SM = 2
# rows one block sums into its fp32 registers: bounds the accumulation
# depth, whose rounding error grows as its square root, whatever the
# replica count (at 128 replicas the split for occupancy alone would be
# 290k rows deep)
MAX_SPLIT_ROWS = 16384
# the grid's y (output tiles) and z (row splits) extents
_MAX_GRID_YZ = 65535
# The profiler range around every call of scaled_grams: the launch and
# the sum of its row-split partials, whatever implements them
GRAM_RANGE = "scaled_grams"


def scaled_grams_plain(
    X: torch.Tensor, S: torch.Tensor, *, op_dtype: str = "float32"
) -> torch.Tensor:
    """The plain torch version of the kernel, the same function:
    ``out[p][i][j] = sum_n x_i * (x_j s_p)`` for ``i <= j``, mirrored
    below the diagonal, with the same operand rounding, summed by
    ``einsum`` in fp32 (TF32 off). In bf16 the two sides round
    differently, so which side carries the scale and which triangle is
    kept are part of the function. One replica at a time: the scaled
    operand is ``(n, P, d)``, so a full replica chunk fits the card."""
    X3, S3, squeeze = _as_batched(X, S)
    R = S3.shape[0]
    out = torch.empty((R, S3.shape[-1], X3.shape[-1], X3.shape[-1]),
                      dtype=torch.float32, device=S3.device)
    for r in range(R):
        Xf = X3[r if X3.shape[0] > 1 else 0].to(torch.float32)
        xs = Xf[:, None, :] * S3[r].to(torch.float32)[:, :, None]  # (n, P, d)
        if op_dtype == "bfloat16":
            Xf, xs = bf16_round(Xf), bf16_round(xs)
        with fp32_matmul():
            full = torch.einsum("ni,npj->pij", Xf, xs)
        out[r] = full.triu() + full.triu(1).transpose(-1, -2)
    return out[0] if squeeze else out


def _as_batched(X, S):
    """(X (R|1, n, d), S (R, n, P), squeeze) for the accepted layouts."""
    squeeze = S.dim() == 2
    S3 = S[None] if squeeze else S
    X3 = X[None] if X.dim() == 2 else X
    return X3, S3, squeeze


def _check(X: torch.Tensor, S: torch.Tensor, op_dtype: str) -> None:
    if op_dtype not in _OP_DTYPES:
        raise ValueError(f"op_dtype must be one of {_OP_DTYPES}, got {op_dtype!r}")
    if X.dtype != torch.float32 or S.dtype != torch.float32:
        raise TypeError(f"X and S must be float32, got {X.dtype}, {S.dtype}")
    if X.device != S.device:
        raise ValueError(f"X on {X.device} but S on {S.device}")
    if S.dim() not in (2, 3) or X.dim() not in (2, 3):
        raise ValueError(f"X must be 2-D or 3-D and S 2-D or 3-D, got "
                         f"{tuple(X.shape)}, {tuple(S.shape)}")
    if S.dim() == 2 and X.dim() != 2:
        raise ValueError("a 2-D S needs a 2-D X")
    if X.dim() == 3 and X.shape[0] != S.shape[0]:
        raise ValueError(f"X has {X.shape[0]} replicas, S {S.shape[0]}")
    if X.shape[-2] != S.shape[-2]:
        raise ValueError(f"X has {X.shape[-2]} rows, S {S.shape[-2]}")
    if not (X.is_contiguous() and S.is_contiguous()):
        raise ValueError("X and S must be contiguous")


def kernel_geometry(n: int, d: int, P: int, R: int, n_sm: int,
                    shared_x: bool = True) -> dict:
    """Launch geometry of the CUDA kernel (pure arithmetic, so the CPU
    tests can check it).

    The grid is (pair groups, output tiles, row splits). A block takes
    ``pg`` consecutive flattened (replica, pair) indices of one X:
    all ``R * P`` share one X (``n_x = 1``), or each replica's ``P`` has
    its own (``n_x = R``); ``groups`` blocks cover one X's pairs. Along
    d there are ``nt`` tiles of 64: ``nt`` diagonal tiles and two
    32-row halves of each of the ``nt (nt - 1) / 2`` tiles above them,
    ``nt**2`` items in all. Rows split so that at least
    ``_BLOCKS_PER_SM`` blocks an SM are launched, at most
    ``MAX_SPLIT_ROWS`` rows a block."""
    n_x = 1 if shared_x else R
    Q = R * P if shared_x else P
    groups = math.ceil(Q / _WARPS)
    pg = math.ceil(Q / groups)
    nt = math.ceil(d / _TILE)
    if nt * nt > _MAX_GRID_YZ:
        raise ValueError(f"d={d} needs {nt * nt} output tiles, beyond the "
                         f"grid's y extent {_MAX_GRID_YZ}")
    want_splits = max(1, math.ceil(_BLOCKS_PER_SM * n_sm
                                   / (n_x * groups * nt * nt)))
    rows_per_split = _ROW_TILE * min(
        math.ceil(math.ceil(n / want_splits) / _ROW_TILE),
        max(1, MAX_SPLIT_ROWS // _ROW_TILE),
    )
    splits = max(1, math.ceil(n / rows_per_split))
    if splits > _MAX_GRID_YZ:
        raise ValueError(f"n={n} rows need {splits} row splits "
                         f"(at most {_MAX_GRID_YZ})")
    return dict(n_x=n_x, pg=pg, groups=groups, nt=nt, splits=splits,
                rows_per_split=rows_per_split)


def launch_bytes(n: int, d: int, P: int) -> float:
    """Device bytes one replica adds to a launch of many replicas: its
    ``(P, d, d)`` output and its ``ceil(n / MAX_SPLIT_ROWS)`` row-split
    partials, with one to spare for rounding to row tiles. (A launch of
    few replicas splits rows finer, for occupancy, but is small.)"""
    return 4.0 * (math.ceil(n / MAX_SPLIT_ROWS) + 2) * P * d * d


def declare(lib) -> None:
    """The signatures of the csrc/scaled_gram.cu functions called here."""
    lib.sbt_scaled_gram.restype = I32
    lib.sbt_scaled_gram.argtypes = [
        VP, I64, VP, VP, VP,               # X, x_rstride, S, out, partials
        I32, I32, I32, I32,                # n, d, P, R
        I32, I32, I32, I32, I32, I32,      # n_x pg groups nt splits rows
        I32, VP,                           # bf16, stream
    ]
    lib.sbt_gram_mma_probe.restype = I32
    lib.sbt_gram_mma_probe.argtypes = [
        VP, VP, VP, VP,                    # xa, xb, s, out
        I32, VP,                           # bf16, stream
    ]


def _launch(X, S, op_dtype):
    from spark_bagging_tpu_torch.parallel.compat import count_launch

    X3, S3, squeeze = _as_batched(X, S)
    R, n, P = S3.shape
    d = X3.shape[-1]
    dev = S.device
    out = torch.empty((R, P, d, d), dtype=torch.float32, device=dev)
    if n == 0 or R == 0:
        out.zero_()
        return out[0] if squeeze else out
    shared_x = X3.shape[0] == 1
    g = kernel_geometry(
        n, d, P, R, torch.cuda.get_device_properties(dev).multi_processor_count,
        shared_x=shared_x,
    )
    partials = (
        torch.empty((g["splits"], R, P, d, d), dtype=torch.float32, device=dev)
        if g["splits"] > 1 else out
    )
    lib = kernels.library()
    with torch.cuda.device(dev):
        err = lib.sbt_scaled_gram(
            X3.data_ptr(), 0 if shared_x else n * d, S3.data_ptr(),
            out.data_ptr(), partials.data_ptr(), n, d, P, R,
            g["n_x"], g["pg"], g["groups"], g["nt"], g["splits"],
            g["rows_per_split"], int(op_dtype == "bfloat16"),
            kernels.stream(dev),
        )
    kernels.check(lib, err, "scaled_gram")
    count_launch(scaled_grams)
    return out[0] if squeeze else out


def mma_tile_probe(xa: torch.Tensor, xb: torch.Tensor, s: torch.Tensor, *,
                   op_dtype: str) -> torch.Tensor:
    """One warp's ``(16, 8)`` accumulator tile over one k step, computed
    on the card by the kernel's own staging layout, fragment loads and
    ``mma.sync``: ``out[m, n] = sum_k xa[k, m] * (xb[k, n] * s[k])`` with
    the kernel's operand rounding. ``xa (K, 16)``, ``xb (K, 8)``,
    ``s (K,)``, K = 8 in "float32" (m16n8k8 TF32, as 3xTF32) and 16 in
    "bfloat16" (m16n8k16). For the card tests of the fragment layouts;
    CUDA tensors only, and not counted as a launch."""
    if op_dtype not in _OP_DTYPES:
        raise ValueError(f"op_dtype must be one of {_OP_DTYPES}, got {op_dtype!r}")
    K = 16 if op_dtype == "bfloat16" else 8
    for name, t, shape in (("xa", xa, (K, 16)), ("xb", xb, (K, 8)),
                           ("s", s, (K,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of shape {shape}")
    out = torch.empty((16, 8), dtype=torch.float32, device=xa.device)
    lib = kernels.library()
    with torch.cuda.device(xa.device):
        err = lib.sbt_gram_mma_probe(
            xa.data_ptr(), xb.data_ptr(), s.data_ptr(), out.data_ptr(),
            int(op_dtype == "bfloat16"), kernels.stream(xa.device))
    kernels.check(lib, err, "gram_mma_probe")
    return out


def scaled_grams(
    X: torch.Tensor, S: torch.Tensor, *, op_dtype: str = "float32"
) -> torch.Tensor:
    """``(R, P, d, d)`` (or ``(P, d, d)`` for a 2-D ``S``) stack of
    ``X^T diag(S[..., p]) X``; rows with zero scale are inert.

    ``scaled_grams.launches`` counts kernel launches (CUDA tensors only).
    """
    _check(X, S, op_dtype)
    with profiler_range(GRAM_RANGE):
        if S.device.type == "cpu":
            return scaled_grams_plain(X, S, op_dtype=op_dtype)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        return _launch(X, S, op_dtype)


scaled_grams.launches = 0
LAUNCH_COUNTERS = {"scaled_gram": (scaled_grams, "launches")}
