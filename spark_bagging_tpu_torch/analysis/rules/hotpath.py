"""Hot-path allocation rules — constant-factor hygiene for the
per-request serving path.

The reference package's tracing work found (via its serving bench
gate) that a single ``os.urandom`` call per request cost 2.2x serving
throughput on that host's kernel; the class of bug — per-call work
that LOOKS free but dominates once the path runs tens of thousands of
times a second — is visible in the source, so it is a lint class. Functions on the serving
hot path mark themselves ``# sbt-lint: hot-path`` on (or directly
above) the ``def``; inside them the rule flags:

- ``os.urandom(...)`` — an entropy syscall per call (that
  regression verbatim; mint ids from a seeded prefix + atomic counter
  instead);
- dict/set/list comprehensions — a fresh allocation plus an
  interpreter loop per call (hoist to module/setup scope, or build
  only behind a ``telemetry.enabled()``-style gate);
- logging calls (``log.info(...)``, ``logging.debug(...)``, any
  ``log``-named receiver) — formatting plus handler dispatch per call
  (log at the batch boundary, or not at all on the hot path).

The marker is opt-in, like ``shared-state``: most functions are cold
and a blanket rule would drown the contract in noise. A justified
exception carries a regular ``disable=hot-path-alloc`` suppression.
"""

from __future__ import annotations

import ast
from typing import Iterator

from spark_bagging_tpu_torch.analysis.lint import (
    Finding,
    LintContext,
    dotted_name,
    rule,
    walk_skip_defs,
)

_LOG_METHODS = {"debug", "info", "warning", "warn", "error",
                "exception", "critical", "log"}


def _is_logging_call(node: ast.Call) -> bool:
    """``<log-ish>.info(...)`` / ``logging.debug(...)`` — a receiver
    whose dotted name mentions ``log`` calling a level method."""
    func = node.func
    if not (isinstance(func, ast.Attribute)
            and func.attr in _LOG_METHODS):
        return False
    base = dotted_name(func.value) or ""
    return "log" in base.lower()


@rule("hot-path-alloc")
def hot_path_alloc(ctx: LintContext) -> Iterator[Finding]:
    """Per-call allocation/formatting work inside a ``# sbt-lint:
    hot-path`` function (urandom, comprehensions, logging calls)."""
    for fn in ctx.nodes():
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not ctx.marked(fn, "hot-path"):
            continue
        for node in walk_skip_defs(fn):
            if isinstance(node, ast.Call):
                if dotted_name(node.func) == "os.urandom":
                    yield ctx.finding(
                        "hot-path-alloc", node,
                        f"os.urandom() inside hot-path `{fn.name}`: an "
                        "entropy syscall per call cost 2.2x serving "
                        "throughput once (per-request trace ids); pre-draw a "
                        "seed prefix and append an atomic counter",
                    )
                elif _is_logging_call(node):
                    yield ctx.finding(
                        "hot-path-alloc", node,
                        f"logging call inside hot-path `{fn.name}`: "
                        "format + handler dispatch per request; log at "
                        "the batch boundary or drop it",
                    )
            elif isinstance(node, (ast.DictComp, ast.SetComp,
                                   ast.ListComp)):
                kind = {ast.DictComp: "dict", ast.SetComp: "set",
                        ast.ListComp: "list"}[type(node)]
                yield ctx.finding(
                    "hot-path-alloc", node,
                    f"{kind} comprehension inside hot-path "
                    f"`{fn.name}`: allocation + interpreter loop per "
                    "call; hoist it, or build it only behind an "
                    "enabled()-style gate",
                )
