"""Fault-swallowing rules — silence is the failure mode.

The fault-tolerance layer turns serving failures into counted,
flight-recorded, retry-able events; its enemy is the handler that eats
a fault with nothing to show for it. ``except Exception: pass`` in a
serving or telemetry path converts a crash the supervisor would catch
(or an incident the flight recorder would dump) into a silent quality
gap nobody pages on. The pattern is visible in the source, so it is a
lint class.

``swallowed-fault`` flags BROAD handlers — bare ``except``,
``except Exception``, ``except BaseException`` (alone or in a tuple)
— inside ``spark_bagging_tpu_torch/serving/`` and
``spark_bagging_tpu_torch/telemetry/`` (the reference package's scope,
moved to the port's own directories) whose body shows no evidence the
fault went ANYWHERE: no re-raise, no ``warnings.warn``, no telemetry
(``inc``/``observe``/``set_gauge``/``emit_event``), no logging, no
``future.set_exception`` delivery, no flight ``dump``. Narrow handlers
(``except OSError``) are deliberate-by-construction and stay out of
scope, as does the rest of the tree — serving and telemetry are where
a swallowed fault costs an incident its evidence. A justified swallow
(best-effort instrumentation that must never fail its host) carries a
regular ``disable=swallowed-fault`` suppression with a one-line
justification, like every other self-hosted exception in the port.
"""

from __future__ import annotations

import ast
from typing import Iterator

from spark_bagging_tpu_torch.analysis.lint import (
    Finding,
    LintContext,
    dotted_name,
    rule,
)

_BROAD = {"Exception", "BaseException"}

# call-name fragments that count as "the fault went somewhere": raised
# again, warned, counted, logged, delivered to a waiting future, or
# dumped by the flight recorder
_EVIDENCE_TAILS = ("inc", "inc_many", "observe", "set_gauge",
                   "emit_event", "emit", "set_exception", "warn",
                   "record", "dump")


def _in_scope(path: str) -> bool:
    norm = path.replace("\\", "/")
    # "<string>" is lint_source's default path — keeps the rule
    # testable against the BAD/GOOD fixture snippets
    return (
        "spark_bagging_tpu_torch/serving" in norm
        or "spark_bagging_tpu_torch/telemetry" in norm
        or norm == "<string>"
    )


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    names: list[ast.AST] = list(t.elts) if isinstance(t, ast.Tuple) else [t]
    for n in names:
        name = dotted_name(n) or ""
        if name.split(".")[-1] in _BROAD:
            return True
    return False


def _handled(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = (dotted_name(node.func) or "").lower()
            if not name:
                continue
            head = name.split(".")[0]
            tail = name.rsplit(".", 1)[-1]
            if "telemetry" in name or "warn" in tail or "log" in head:
                return True
            if tail in _EVIDENCE_TAILS:
                return True
    return False


@rule("swallowed-fault")
def swallowed_fault(ctx: LintContext) -> Iterator[Finding]:
    """Broad except handler in serving/telemetry code that swallows the
    fault silently (no re-raise, no telemetry, no warning, no
    delivery)."""
    if not _in_scope(ctx.path):
        return
    for node in ctx.nodes():
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if not _is_broad(handler):
                continue
            if _handled(handler):
                continue
            caught = ("bare except" if handler.type is None else
                      f"except {ast.unparse(handler.type)}")
            yield ctx.finding(
                "swallowed-fault", handler,
                f"{caught} swallows the fault silently on a "
                "serving/telemetry path: re-raise, warn, count "
                "(telemetry.inc/emit_event), or deliver it "
                "(future.set_exception) — a fault nobody can see is "
                "an incident with no evidence",
            )
