"""Host-device synchronization rules.

The throughput story of scalable bagging (Kleiner et al.'s BLB, the
streaming Poisson bootstrap) rests on the hot loop never round-tripping
to the host per item: one blocking pull (``.item()``, ``.cpu()``,
``.numpy()``, ``np.asarray`` of a device tensor,
``torch.cuda.synchronize``) inside a per-chunk or per-request path
serializes the dispatch pipeline and caps throughput at host latency.
Two lexical contexts are load-bearing enough to lint:

- inside a CUDA-graph capture (between ``capture_begin(...)`` and its
  ``capture_end()``, or in a ``with torch.cuda.graph(...)`` body) — the
  port's counterpart of a jit body — these calls either invalidate the
  capture or bake one launch's value into every replay;
- inside a ``telemetry.span``/``phase`` block — the marker the port
  puts exactly on its hot phases — they silently turn a pipelined
  dispatch into a synchronous one.
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

# device->host pulls / full-queue drains by dotted callable name
_SYNC_CALLS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "jax.device_get", "jax.block_until_ready", "torch.cuda.synchronize",
}
# method names whose call on ANY receiver forces a sync
_SYNC_METHODS = {"item", "tolist", "block_until_ready", "cpu", "numpy"}
# builtins that coerce a traced array to a Python scalar
_SCALAR_BUILTINS = {"float", "int", "bool"}


def _sync_call(node: ast.AST, *, scalar_builtins: bool = True) -> str | None:
    """Name of the host-sync this Call performs, or None.

    ``scalar_builtins=False`` skips ``float()/int()/bool()`` — outside a
    trace they only sync when fed a device array, and the common span
    pattern (``int(X.shape[0])``) is pure host shape math.
    """
    if not isinstance(node, ast.Call):
        return None
    name = dotted_name(node.func)
    if name in _SYNC_CALLS:
        return name
    if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
        return f".{node.func.attr}()"
    if (
        scalar_builtins
        and name in _SCALAR_BUILTINS
        and len(node.args) == 1
        and not isinstance(node.args[0], ast.Constant)
    ):
        return f"{name}()"
    return None


def _is_graph_with(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g, ...)``: the capture context manager."""
    if not isinstance(item.context_expr, ast.Call):
        return False
    name = dotted_name(item.context_expr.func) or ""
    return name == "cuda.graph" or name.endswith(".cuda.graph")


def _method_call(node: ast.AST, method: str) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == method)


def _pos(node: ast.AST) -> tuple[int, int]:
    return node.lineno, node.col_offset


def _capture_spans(scope: ast.AST) -> list[tuple[tuple[int, int],
                                                 tuple[int, int]]]:
    """Source spans from each ``capture_begin(...)`` call to the first
    ``capture_end()`` after it in the same function."""
    nodes = list(walk_skip_defs(scope))
    begins = sorted(_pos(n) for n in nodes
                    if _method_call(n, "capture_begin"))
    ends = sorted(_pos(n) for n in nodes if _method_call(n, "capture_end"))
    spans = []
    for b in begins:
        after = [e for e in ends if e > b]
        if after:
            spans.append((b, after[0]))
    return spans


def _scopes(ctx: LintContext) -> list[ast.AST]:
    return [ctx.tree] + [n for n in ctx.nodes()
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))]


@rule("host-sync-in-capture")
def host_sync_in_capture(ctx: LintContext) -> Iterator[Finding]:
    """Host-sync call (``.item()``/``.cpu()``/``float()``/...) inside a
    CUDA-graph capture — an invalidated capture or a value baked into
    every replay, never a per-replay value."""
    if "capture_begin" not in ctx.source and "graph(" not in ctx.source:
        return  # no capture in this file
    for scope in _scopes(ctx):
        name = getattr(scope, "name", "<module>")
        spans = _capture_spans(scope)
        for node in walk_skip_defs(scope):
            what = _sync_call(node)
            if what and any(b < _pos(node) < e for b, e in spans):
                yield ctx.finding(
                    "host-sync-in-capture", node,
                    f"{what} between capture_begin() and capture_end() "
                    f"in `{name}`: a host sync during a CUDA-graph "
                    "capture invalidates it or bakes one launch's value "
                    "into every replay; compute on the device or move "
                    "it outside the capture",
                )
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(_is_graph_with(i) for i in node.items):
                continue
            for stmt in node.body:
                for sub in [stmt, *walk_skip_defs(stmt)]:
                    what = _sync_call(sub)
                    if what:
                        yield ctx.finding(
                            "host-sync-in-capture", sub,
                            f"{what} inside a `torch.cuda.graph` capture "
                            f"in `{name}`: a host sync during a CUDA-graph "
                            "capture invalidates it or bakes one launch's "
                            "value into every replay; compute on the "
                            "device or move it outside the capture",
                        )


def _is_span_with(item: ast.withitem) -> bool:
    if not isinstance(item.context_expr, ast.Call):
        return False
    name = dotted_name(item.context_expr.func)
    return bool(name) and name.split(".")[-1] in ("span", "phase")


@rule("host-sync-in-span")
def host_sync_in_span(ctx: LintContext) -> Iterator[Finding]:
    """Blocking device pull inside a ``telemetry.span``/``phase`` block
    (the hot-path marker) — the span's phase becomes host-latency-bound."""
    for node in ctx.nodes():
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_is_span_with(i) for i in node.items):
            continue
        for stmt in node.body:
            for sub in [stmt, *walk_skip_defs(stmt)]:
                what = _sync_call(sub, scalar_builtins=False)
                if what:
                    yield ctx.finding(
                        "host-sync-in-span", sub,
                        f"{what} inside a telemetry span: this phase is "
                        "instrumented as hot, and the call blocks the "
                        "dispatch pipeline; pull results after the span "
                        "or justify with a suppression",
                    )
