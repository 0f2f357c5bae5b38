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

``op_dtype`` is the operand mode: ``"float32"`` multiplies exact fp32
operands; ``"bfloat16"`` rounds X and the scaled operand ``x * s`` to
bfloat16 and multiplies and sums them in fp32.
"""

from __future__ import annotations

import math

import torch

from spark_bagging_tpu_torch.ops.precision import bf16_round, fp32_matmul

_OP_DTYPES = ("float32", "bfloat16")
# The kernel's compile-time tiling, decided here only: utils/native.py
# passes these to nvcc as -D defines, and csrc/scaled_gram.cu refuses to
# build without them. Each thread accumulates TILES_PER_THREAD 4x4
# output tiles; a block has at most MAX_THREADS threads.
CUDA_DEFINES = {
    "SBT_GRAM_TILES_PER_THREAD": 4,
    "SBT_GRAM_MAX_THREADS": 256,
}
_TILES_PER_THREAD = CUDA_DEFINES["SBT_GRAM_TILES_PER_THREAD"]
_MAX_THREADS = CUDA_DEFINES["SBT_GRAM_MAX_THREADS"]
# dynamic shared memory a block may take without an opt-in attribute
_SMEM_BYTES = 48 * 1024
_MAX_ROW_TILE = 32
# blocks in flight the row split aims for, per streaming multiprocessor
_BLOCKS_PER_SM = 4
# rows one block sums into its fp32 registers: bounds the accumulation
# depth, whose rounding error grows as its square root, whatever the
# replica count (at 128 replicas the split for occupancy alone would be
# 290k rows deep)
MAX_SPLIT_ROWS = 16384


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


def kernel_geometry(n: int, d: int, P: int, R: int, n_sm: int) -> dict:
    """Launch geometry of the CUDA kernel (pure arithmetic, so the CPU
    tests can check it): pairs per block, row split, row tile, threads."""
    d_pad = 4 * math.ceil(d / 4)
    nb = d_pad // 4
    tiles_per_pair = nb * (nb + 1) // 2
    pg_max = (_TILES_PER_THREAD * _MAX_THREADS) // tiles_per_pair
    if pg_max < 1:
        raise ValueError(
            f"d={d} is beyond the kernel's register tiling "
            f"(at most {_TILES_PER_THREAD * _MAX_THREADS} 4x4 tiles a block)"
        )
    groups = math.ceil(P / pg_max)
    pg = math.ceil(P / groups)
    threads = 32 * math.ceil(pg * tiles_per_pair / _TILES_PER_THREAD / 32)
    row_tile = max(1, min(_MAX_ROW_TILE,
                          _SMEM_BYTES // (4 * (pg + 1) * d_pad)))
    want_splits = max(1, math.ceil(_BLOCKS_PER_SM * n_sm / (groups * R)))
    rows_per_split = min(
        row_tile * math.ceil(math.ceil(n / want_splits) / row_tile),
        row_tile * max(1, MAX_SPLIT_ROWS // row_tile),
    )
    splits = max(1, math.ceil(n / rows_per_split))
    if splits > 65535:  # the grid's z extent
        raise ValueError(f"n={n} rows need {splits} row splits (at most 65535)")
    return dict(d_pad=d_pad, pg=pg, groups=groups, splits=splits,
                rows_per_split=rows_per_split, row_tile=row_tile,
                threads=threads)


def launch_bytes(n: int, d: int, P: int) -> float:
    """Device bytes one replica adds to a launch of many replicas: its
    ``(P, d, d)`` output and its ``ceil(n / MAX_SPLIT_ROWS)`` row-split
    partials, with one to spare for rounding to row tiles. (A launch of
    few replicas splits rows finer, for occupancy, but is small.)"""
    return 4.0 * (math.ceil(n / MAX_SPLIT_ROWS) + 2) * P * d * d


def _launch(X, S, op_dtype):
    from spark_bagging_tpu_torch.utils import native

    X3, S3, squeeze = _as_batched(X, S)
    R, n, P = S3.shape
    d = X3.shape[-1]
    dev = S.device
    out = torch.empty((R, P, d, d), dtype=torch.float32, device=dev)
    if n == 0 or R == 0:
        out.zero_()
        return out[0] if squeeze else out
    g = kernel_geometry(
        n, d, P, R, torch.cuda.get_device_properties(dev).multi_processor_count
    )
    partials = (
        torch.empty((g["splits"], R, P, d, d), dtype=torch.float32, device=dev)
        if g["splits"] > 1 else out
    )
    lib = native.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sbt_scaled_gram(
            X3.data_ptr(), 0 if X.dim() == 2 else n * d, S3.data_ptr(),
            out.data_ptr(), partials.data_ptr(), n, d, P, R,
            g["d_pad"], g["pg"], g["groups"], g["splits"],
            g["rows_per_split"], g["row_tile"], g["threads"],
            int(op_dtype == "bfloat16"), stream,
        )
    native.check(lib, err, "scaled_gram")
    scaled_grams.launches += 1
    return out[0] if squeeze else out


def scaled_grams(
    X: torch.Tensor, S: torch.Tensor, *, op_dtype: str = "float32"
) -> torch.Tensor:
    """``(R, P, d, d)`` (or ``(P, d, d)`` for a 2-D ``S``) stack of
    ``X^T diag(S[..., p]) X``; rows with zero scale are inert.

    ``scaled_grams.launches`` counts kernel launches (CUDA tensors only).
    """
    _check(X, S, op_dtype)
    if S.device.type == "cpu":
        return scaled_grams_plain(X, S, op_dtype=op_dtype)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    return _launch(X, S, op_dtype)


scaled_grams.launches = 0
