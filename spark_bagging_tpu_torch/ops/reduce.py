"""Cross-device reduction helpers.

Every row-dimension reduction in the learners goes through
``maybe_psum`` so the same code runs data-parallel: inside a
``parallel.compat.shard_map`` body a named axis sums over the mesh
shards (in a fixed shard order, so a rerun is bitwise the same), and
``None`` is the identity, as in the JAX package.
"""

from __future__ import annotations


def maybe_psum(x, axis_name: str | None = None):
    """The sum over ``axis_name``'s shards if set; identity otherwise. A
    name set outside a shard_map body raises."""
    if axis_name is None:
        return x
    from spark_bagging_tpu_torch.parallel import compat

    return compat.psum(x, axis_name)
