"""Thread-safety rules for classes that declare shared state.

The serving path is multi-threaded: submitters,
a batcher worker, swap callers, and telemetry emitters all touch the
same objects. Classes that are part of that contract mark themselves
with ``# sbt-lint: shared-state`` on (or directly above) the class
statement; the rule then requires every mutation of ``self`` state
outside ``__init__``/``__new__`` to sit lexically inside a
``with self.<...lock...>:`` block. The marker is opt-in because most
classes here are single-threaded by design (estimators, learners) and
a blanket rule would drown the real contract in noise.
"""

from __future__ import annotations

import ast
from typing import Iterator

from spark_bagging_tpu_torch.analysis.lint import Finding, LintContext, rule

_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__"}


def _self_mutations(stmt: ast.AST) -> Iterator[tuple[ast.AST, str]]:
    """(node, attr) pairs where this statement writes ``self.attr`` or
    ``self.attr[...]``."""
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    for t in targets:
        node = t
        if isinstance(node, (ast.Tuple, ast.List)):
            for el in node.elts:
                yield from _self_mutations_expr(el)
            continue
        yield from _self_mutations_expr(node)


def _self_mutations_expr(node: ast.expr) -> Iterator[tuple[ast.AST, str]]:
    while isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        yield node, node.attr


def _is_lock_with(item: ast.withitem) -> bool:
    """``with self._lock:`` — any attribute of self whose name mentions
    lock (``_lock``, ``_build_lock``, ``lock``)."""
    expr = item.context_expr
    # also accept self._lock.acquire_timeout(...) style calls
    if isinstance(expr, ast.Call):
        expr = expr.func
        if isinstance(expr, ast.Attribute):
            expr = expr.value
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
        and "lock" in expr.attr.lower()
    ):
        return True
    return False


@rule("shared-state-unlocked")
def shared_state_unlocked(ctx: LintContext) -> Iterator[Finding]:
    """Mutation of a ``# sbt-lint: shared-state`` class's attributes
    outside a ``with self.<lock>:`` block (``__init__`` exempt)."""
    for cls in ctx.nodes():
        if not isinstance(cls, ast.ClassDef):
            continue
        if not ctx.marked(cls, "shared-state"):
            continue
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue
            if method.name in _EXEMPT_METHODS:
                continue
            yield from _check_block(
                ctx, cls.name, method.name, method.body, locked=False
            )


def _check_block(
    ctx: LintContext, cls: str, method: str,
    body: list[ast.stmt], *, locked: bool,
) -> Iterator[Finding]:
    for stmt in body:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = locked or any(_is_lock_with(i) for i in stmt.items)
            yield from _check_block(ctx, cls, method, stmt.body,
                                    locked=inner)
            continue
        if not locked:
            for node, attr in _self_mutations(stmt):
                yield ctx.finding(
                    "shared-state-unlocked", node,
                    f"`self.{attr}` mutated in `{cls}.{method}` outside "
                    "a `with self.<lock>:` block, but the class is "
                    "marked shared-state; take the lock or justify "
                    "with a suppression",
                )
        # recurse into nested compound statements (if/for/try bodies)
        for sub_body in _sub_blocks(stmt):
            yield from _check_block(ctx, cls, method, sub_body,
                                    locked=locked)


def _sub_blocks(stmt: ast.stmt) -> list[list[ast.stmt]]:
    blocks: list[list[ast.stmt]] = []
    for field in ("body", "orelse", "finalbody"):
        b = getattr(stmt, field, None)
        if isinstance(b, list) and not isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.With, ast.AsyncWith)
        ):
            blocks.append(b)
    for h in getattr(stmt, "handlers", []) or []:
        blocks.append(h.body)
    return blocks
