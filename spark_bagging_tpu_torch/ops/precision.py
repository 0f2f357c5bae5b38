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


@contextlib.contextmanager
def fp32_matmul():
    """Full-float32 matmuls and convolutions (TF32 off) for the block,
    restoring the previous settings on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
