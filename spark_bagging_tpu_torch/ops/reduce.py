"""Cross-device reduction helpers.

Every row-dimension reduction in the learners goes through
``maybe_psum`` so the same code runs data-parallel: inside a
``parallel.compat.shard_map`` body a named axis sums over the mesh
shards (in a fixed shard order, so a rerun is bitwise the same), and
``None`` is the identity, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence


def maybe_psum(x, axis_name: str | None = None):
    """The sum over ``axis_name``'s shards if set; identity otherwise. A
    name set outside a shard_map body raises."""
    if axis_name is None:
        return x
    from spark_bagging_tpu_torch.parallel import compat

    return compat.psum(x, axis_name)


def maybe_psum_many(tensors: Sequence, axis_name: str | None = None) -> list:
    """Each tensor's :func:`maybe_psum`, in one collective: the tensors
    (of one dtype) are flattened into one, summed over the shards, and
    split back to their shapes. The sums are the separate calls' bits."""
    if axis_name is None:
        return list(tensors)
    import torch

    flat = maybe_psum(torch.cat([t.reshape(-1) for t in tensors]), axis_name)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out
