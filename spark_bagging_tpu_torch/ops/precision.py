"""Precision policy: what the JAX package's ``precision`` names mean here.

- "highest" / "float32": float32 operands everywhere.
- "high" / "default": bfloat16 operands for the scaled-Gram kernel
  only (ops/gram.py), with float32 accumulation, as the JAX package maps
  these names for its Pallas kernel. Every other matmul stays float32.

Every matmul of the solvers runs inside :func:`fp32_matmul`, which
turns TF32 off for cuBLAS and cuDNN explicitly: a float32 result must
not depend on a process-wide default that another library may flip.
A switch of Hessian implementation (blocked, kernel) must not change
numerics beyond summation order at the same precision.

Trees ignore these names: their split search takes its operand type
from ``hist_dtype`` and sums in full float32 (models/tree.py), so the
dense product and the histogram kernel give the same trees.
"""

from __future__ import annotations

import contextlib

import torch

_GRAM_OP_DTYPE = {
    "highest": "float32",
    "float32": "float32",
    "high": "bfloat16",
    "default": "bfloat16",
}


def gram_op_dtype(precision: str) -> str:
    """The scaled-Gram kernel's operand mode for a precision name."""
    try:
        return _GRAM_OP_DTYPE[precision]
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(_GRAM_OP_DTYPE)}, "
            f"got {precision!r}"
        ) from None


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even) and back to float32:
    the operand rounding of the kernels' bf16 modes."""
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def fp32_matmul():
    """Full-float32 accumulation for the block's matmuls and
    convolutions, restoring the previous settings on exit: TF32 off,
    and no reduced-precision reduction inside a bfloat16 product (which
    PyTorch allows by default), so a bf16 x bf16 -> fp32 product of
    integers sums them exactly. The JAX package pins the same with
    ``mosaic_dot_precision`` around its tree split search."""
    cuda_mm = torch.backends.cuda.matmul
    prev = (cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            cuda_mm.allow_bf16_reduced_precision_reduction)
    cuda_mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (cuda_mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         cuda_mm.allow_bf16_reduced_precision_reduction) = prev
