"""Cross-device reduction helpers.

Every row-dimension reduction in the learners goes through
``maybe_psum`` so the same code can later run data-parallel. Until the
sharding slice lands (``torch.distributed.all_reduce``), the port runs
on one device and this is the identity.
"""

from __future__ import annotations


def maybe_psum(x, axis_name: str | None = None):
    """All-reduce over ``axis_name`` if set; identity otherwise."""
    if axis_name is not None:
        raise NotImplementedError(
            "sharded reductions (ROADMAP Queue A: parallel/)"
        )
    return x
