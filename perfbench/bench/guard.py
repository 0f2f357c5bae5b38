"""What a run may not load: JAX and the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's,
so a prefix test would be wrong)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spark_bagging_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
