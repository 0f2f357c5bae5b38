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

On the card ``"float32"`` runs 3xTF32 on the tensor cores: each fp32
operand ``a`` (the fp32 product ``x * s``, and x) is split into
``a_big``, ``a`` cut to TF32's 11 significant bits, and ``a_small = a -
a_big`` (exact in fp32, read by the tensor core cut to TF32 in turn),
and a product is taken as ``a_small*b_big + a_big*b_small +
a_big*b_big``. The cuts and the dropped ``a_small*b_small`` leave a
product off by less than ``3 * 2**-20`` of its size, against fp32's
``2**-24`` rounding: the sums stay well inside the error scale the tests
hold them to (per entry, 1.5e-5 of its absolute sum). Operands with at
most 11 significant bits have ``a_small = 0`` and give exact products.
Each 64-row tile is summed in tensor-core accumulators from zero and
then added into fp32 registers rounding to nearest: the tensor cores'
own accumulation does not round to nearest, and over a block's 16,384
rows its error grew past that scale on an H100.

The two modes run two designs. ``"float32"`` (every Hessian of a fit at
precision "highest") runs warpgroup ``wgmma`` fed by TMA: a prep kernel
writes X's 64-row tiles and their TF32 remainders in the layout
``wgmma`` reads its shared operand from (:func:`scratch_bytes`), a
producer warp stages them into a ring of shared-memory stages, and two
consumer warpgroups multiply 16-row bands of the upper triangle, each
warp building its own (replica, pair)'s scaled rows in registers. The
bands are the kernel source's alone (:func:`wgmma_layout` asks it for
their count). ``"bfloat16"``
runs warp-level ``mma.sync``: in bf16 the side that carries the scale
is part of the function (the plain version's: the columns), and
``wgmma``'s shared operand is the unscaled X.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from spark_bagging_tpu_torch.ops import kernels
from spark_bagging_tpu_torch.ops.kernels import I32, I64, VP
from spark_bagging_tpu_torch.ops.precision import bf16_round, fp32_matmul
from spark_bagging_tpu_torch.ops.ranges import profiler_range

_OP_DTYPES = ("float32", "bfloat16")
# The kernels' compile-time tiling, decided here only: ops/kernels.py
# passes these to nvcc as -D defines, and csrc/scaled_gram.cu refuses to
# build without them. Both designs stage ROW_TILE rows of X a stage and
# promote each row tile's tensor-core sum into round-to-nearest fp32
# registers, over TILE x TILE output tiles. float32 (wgmma): a block is
# CONSUMERS warpgroups, one (replica, pair) a warp, and a producer
# warpgroup filling a ring of STAGES row tiles. bfloat16 (mma.sync): a
# block has WARPS warps, each keeping one (replica, pair)'s output tile.
CUDA_DEFINES = {
    "SBT_GRAM_ROW_TILE": 64,
    "SBT_GRAM_TILE": 64,
    "SBT_GRAM_CONSUMERS": 2,
    "SBT_GRAM_STAGES": 4,
    "SBT_GRAM_WARPS": 8,
}
_ROW_TILE = CUDA_DEFINES["SBT_GRAM_ROW_TILE"]
_TILE = CUDA_DEFINES["SBT_GRAM_TILE"]
_WARPS = CUDA_DEFINES["SBT_GRAM_WARPS"]
# (replica, pair)s a block: one a warp of either design
_PAIRS = {"float32": 4 * CUDA_DEFINES["SBT_GRAM_CONSUMERS"],
          "bfloat16": _WARPS}
# blocks the row split aims for, per streaming multiprocessor (one block
# is resident on an SM: its accumulators take most of the registers)
_BLOCKS_PER_SM = 2
# rows one block sums into its fp32 registers: bounds the accumulation
# depth, whose rounding error grows as its square root, whatever the
# replica count (at 128 replicas the split for occupancy alone would be
# 290k rows deep)
MAX_SPLIT_ROWS = 16384
# the grid's y (items) and z (row splits) extents
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


@functools.cache
def wgmma_layout(d: int) -> tuple[int, int]:
    """``(items, issued)`` of the float32 design at width ``d``: its
    block items along d (the grid's y extent) and the groups of 8
    columns their bands multiply for one (replica, pair), 16 x 8
    products a row of X each. The bands are stated once, in
    csrc/scaled_gram.cu (``SBT_GRAM_SHAPES``, ``decode_item``), and
    counted there by ``sbt_gram_items``, host arithmetic of the kernel
    library."""
    issued = ctypes.c_longlong()
    items = kernels.library().sbt_gram_items(d, ctypes.byref(issued))
    return items, issued.value


def _sync_issued_products(d: int) -> int:
    """Products a (replica, pair) of the bfloat16 design issues per row:
    16 x 8 for each 16x8 tile kept."""
    nt = -(-d // _TILE)
    issued = 0
    for T in range(nt):  # diagonal tiles: 16x8 tiles touching i <= j
        mi_n = min(4, -(-(d - 64 * T) // 16))
        nj_n = min(8, -(-(d - 64 * T) // 8))
        issued += 128 * sum(1 for mi in range(mi_n) for nj in range(nj_n)
                            if nj >= 2 * mi)
    for I in range(nt):  # above the diagonal: two 32-row halves
        for J in range(I + 1, nt):
            issued += 2 * 128 * 2 * min(8, -(-(d - 64 * J) // 8))
    return issued


def kernel_geometry(n: int, d: int, P: int, R: int, n_sm: int,
                    shared_x: bool = True, op_dtype: str = "float32") -> dict:
    """Launch geometry of the CUDA kernel of ``op_dtype``'s design:
    arithmetic over the shapes, and for float32 the band count the
    kernel library states (:func:`wgmma_layout`, which the CPU tests
    replay from the kernel source).

    The grid is (pair groups, items, row splits). A block takes ``pg``
    consecutive flattened (replica, pair) indices of one X, at most one
    a warp: all ``R * P`` share one X (``n_x = 1``), or each replica's
    ``P`` has its own (``n_x = R``); ``groups`` blocks cover one X's
    pairs. ``items`` cut the upper triangle along d: the wgmma design's
    bands (:func:`wgmma_layout`), or the mma.sync design's ``nt**2``
    (``nt`` diagonal 64x64 tiles and two 32-row halves of each tile
    above them). Rows split so that at least ``_BLOCKS_PER_SM`` blocks
    an SM are launched, at most ``MAX_SPLIT_ROWS`` rows a block.
    ``issued_share`` is the upper triangle's ``d (d + 1) / 2`` entries
    over the products the design issues for them."""
    n_x = 1 if shared_x else R
    Q = R * P if shared_x else P
    groups = math.ceil(Q / _PAIRS[op_dtype])
    pg = math.ceil(Q / groups)
    if op_dtype == "float32":
        items, band_groups = wgmma_layout(d)
        issued = 128 * band_groups
    else:
        items, issued = math.ceil(d / _TILE) ** 2, _sync_issued_products(d)
    if items > _MAX_GRID_YZ:
        raise ValueError(f"d={d} needs {items} output items, beyond the "
                         f"grid's y extent {_MAX_GRID_YZ}")
    want_splits = max(1, math.ceil(_BLOCKS_PER_SM * n_sm
                                   / (n_x * groups * items)))
    rows_per_split = _ROW_TILE * min(
        math.ceil(math.ceil(n / want_splits) / _ROW_TILE),
        max(1, MAX_SPLIT_ROWS // _ROW_TILE),
    )
    splits = max(1, math.ceil(n / rows_per_split))
    if splits > _MAX_GRID_YZ:
        raise ValueError(f"n={n} rows need {splits} row splits "
                         f"(at most {_MAX_GRID_YZ})")
    return dict(n_x=n_x, pg=pg, groups=groups, items=items, splits=splits,
                rows_per_split=rows_per_split,
                issued_share=d * (d + 1) / 2 / issued)


def image_shape(n: int, d: int, n_x: int = 1) -> tuple[int, ...]:
    """The float32 design's scratch: for each of ``n_x`` X matrices, its
    64-row tiles in the layout ``wgmma`` reads, X itself and then its
    TF32 remainder (``(2, n_x, tiles, groups, 512)`` floats, one
    8-feature group of a tile 2 KB)."""
    return (2, n_x, -(-n // _ROW_TILE), -(-d // 8), 8 * _ROW_TILE)


def scratch_bytes(n: int, d: int, op_dtype: str = "float32") -> float:
    """Device bytes of the scratch one X's launch allocates beside its
    output and partials: the float32 design's images of X (260 MB at
    the headline's 581,012 x 55); none in bfloat16."""
    if op_dtype != "float32":
        return 0.0
    return 4.0 * math.prod(image_shape(n, d))


def launch_bytes(n: int, d: int, P: int) -> float:
    """Device bytes one replica adds to a launch of many replicas: its
    ``(P, d, d)`` output and its ``ceil(n / MAX_SPLIT_ROWS)`` row-split
    partials, with one to spare for rounding to row tiles. (A launch of
    few replicas splits rows finer, for occupancy, but is small.) The
    X images are per X, :func:`scratch_bytes`."""
    return 4.0 * (math.ceil(n / MAX_SPLIT_ROWS) + 2) * P * d * d


def declare(lib) -> None:
    """The signatures of the csrc/scaled_gram.cu functions called here."""
    lib.sbt_scaled_gram.restype = I32
    lib.sbt_scaled_gram.argtypes = [
        VP, I64, VP, VP, VP, VP,           # X, x_rstride, S, out, partials, img
        I32, I32, I32, I32,                # n, d, P, R
        I32, I32, I32, I32, I32,           # n_x pg groups splits rows
        I32, VP, VP,                       # bf16, wgmma (int*), stream
    ]
    lib.sbt_gram_items.restype = I32
    lib.sbt_gram_items.argtypes = [I32, VP]  # d, issued (long long*)
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
        shared_x=shared_x, op_dtype=op_dtype,
    )
    partials = (
        torch.empty((g["splits"], R, P, d, d), dtype=torch.float32, device=dev)
        if g["splits"] > 1 else out
    )
    wgmma = op_dtype == "float32"
    img = (torch.empty(image_shape(n, d, g["n_x"]), dtype=torch.float32,
                       device=dev) if wgmma else None)
    lib = kernels.library()
    ran_wgmma = ctypes.c_int()
    with torch.cuda.device(dev):
        err = lib.sbt_scaled_gram(
            X3.data_ptr(), 0 if shared_x else n * d, S3.data_ptr(),
            out.data_ptr(), partials.data_ptr(),
            img.data_ptr() if wgmma else None, n, d, P, R,
            g["n_x"], g["pg"], g["groups"], g["splits"],
            g["rows_per_split"], int(not wgmma), ctypes.byref(ran_wgmma),
            kernels.stream(dev),
        )
    kernels.check(lib, err, "scaled_gram")
    count_launch(scaled_grams)
    if ran_wgmma.value:
        count_launch(scaled_grams, "wgmma_launches")
    return out[0] if squeeze else out


def mma_tile_probe(xa: torch.Tensor, xb: torch.Tensor, s: torch.Tensor, *,
                   op_dtype: str) -> torch.Tensor:
    """One k step of the design's products, computed on the card by the
    kernel's own staging layout, fragments and tensor-core instruction,
    with its operand rounding. ``"float32"``: one warpgroup's ``(64, 8)``
    ``wgmma`` m64n8k8 (3xTF32) from the image layout, A from registers
    and B from shared memory, ``out[16 w + m, c] = sum_k xa[k, m] *
    s[w, k] * xb[k, c]`` with ``xa (8, 16)``, ``xb (8, 8)``, ``s (4,
    8)`` (warp w's scale). ``"bfloat16"``: one warp's ``(16, 8)``
    ``mma.sync`` m16n8k16 tile, ``out[m, c] = sum_k xa[k, m] * (xb[k, c]
    * s[k])`` with ``xa (16, 16)``, ``xb (16, 8)``, ``s (16,)``. For the
    card tests of the fragment layouts; CUDA tensors only, and not
    counted as a launch."""
    if op_dtype not in _OP_DTYPES:
        raise ValueError(f"op_dtype must be one of {_OP_DTYPES}, got {op_dtype!r}")
    bf16 = op_dtype == "bfloat16"
    shapes = (((16, 16), (16, 8), (16,)) if bf16
              else ((8, 16), (8, 8), (4, 8)))
    for name, t, shape in zip(("xa", "xb", "s"), (xa, xb, s), shapes):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of shape {shape}")
    out = torch.empty((16 if bf16 else 64, 8), dtype=torch.float32,
                      device=xa.device)
    lib = kernels.library()
    with torch.cuda.device(xa.device):
        err = lib.sbt_gram_mma_probe(
            xa.data_ptr(), xb.data_ptr(), s.data_ptr(), out.data_ptr(),
            int(bf16), kernels.stream(xa.device))
    kernels.check(lib, err, "gram_mma_probe")
    return out


def scaled_grams(
    X: torch.Tensor, S: torch.Tensor, *, op_dtype: str = "float32"
) -> torch.Tensor:
    """``(R, P, d, d)`` (or ``(P, d, d)`` for a 2-D ``S``) stack of
    ``X^T diag(S[..., p]) X``; rows with zero scale are inert.

    ``scaled_grams.launches`` counts kernel launches (CUDA tensors only),
    ``scaled_grams.wgmma_launches`` those the kernel library reports as
    the wgmma design's.
    """
    _check(X, S, op_dtype)
    with profiler_range(GRAM_RANGE):
        if S.device.type == "cpu":
            return scaled_grams_plain(X, S, op_dtype=op_dtype)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        return _launch(X, S, op_dtype)


scaled_grams.launches = 0
scaled_grams.wgmma_launches = 0
LAUNCH_COUNTERS = {"scaled_gram": (scaled_grams, "launches"),
                   "scaled_gram_wgmma": (scaled_grams, "wgmma_launches")}
