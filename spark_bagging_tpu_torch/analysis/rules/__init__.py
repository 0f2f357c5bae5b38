"""Rule modules — importing this package registers every rule with the
engine's registry (``analysis.lint.RULES``). To add a rule: write a
generator decorated with ``@rule("my-rule-name")`` in the thematic
module (or a new one), import the module here, and add a good/bad
fixture pair to ``tests/test_torch_analysis.py`` — the fixture test is
what keeps the rule honest.

The reference package's ``recompile``, ``tracer`` and ``donation``
modules have no counterpart here: the constructs they guard
(``jax.jit`` wrappers and their static arguments, tracers,
``donate_argnums``) do not exist in a torch program. ``host_sync``'s
jit rule has a torch twin, ``host-sync-in-capture``.
"""

from spark_bagging_tpu_torch.analysis.rules import (  # noqa: F401
    host_sync,
    hotpath,
    prng,
    resilience,
    threads,
)
