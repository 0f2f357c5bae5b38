"""AST lint engine of the port — the rule registry, suppression logic,
and walkers.

The failure modes of a threaded torch serving path and of the port's
explicit-key PRNG (hidden host-device syncs, a sync inside a CUDA-graph
capture, PRNG key reuse, unlocked shared state, swallowed faults)
survive unit tests because small fixtures never hit the load conditions
that expose them. They ARE, however, visible in the source: ``.item()``
between ``capture_begin()`` and ``capture_end()``, a key sampled twice
without a ``split``. This module is the engine that finds them; the
rules themselves live in ``analysis/rules/`` and register here via
:func:`rule`.

Design contract:

- **Pure stdlib engine.** This module and the rules import no torch —
  the analysis itself is AST-only and the whole tree parses in well
  under a second. (Reaching it through ``python -m
  spark_bagging_tpu_torch.analysis`` still executes the root package
  ``__init__`` and therefore pays the torch import at startup.)
- **Per-line suppressions.** ``# sbt-lint: disable=rule-a,rule-b`` on
  the flagged line (or on a standalone comment line directly above it)
  silences those rules there; ``disable=all`` silences everything.
  Suppressions are the self-hosting escape hatch: every benign finding
  in the port carries one with a one-line justification.
- **Config.** The port's defaults name the port (the package and
  ``chip_smoke.py``); a ``[tool.sbt-lint-torch]`` table in
  pyproject.toml, where one exists, layers over them, and the CLI
  (``python -m spark_bagging_tpu_torch.analysis``) layers flags on top.
  ``[tool.sbt-lint]`` names the reference package and is never read.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

__all__ = [
    "Finding",
    "LintContext",
    "Rule",
    "RULES",
    "rule",
    "lint_source",
    "lint_file",
    "lint_paths",
    "load_config",
    "render_text",
    "render_json",
    "dotted_name",
]

# -- findings ----------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One lint hit: where, which rule, and why it matters."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


def finding_order(f: Finding) -> tuple:
    """Sort key of a report: position, rule, then the message, so two
    findings at one position come out in one order whatever the order
    of the set they were collected in (string hashing, and so a set's
    iteration, varies from process to process)."""
    return f.path, f.line, f.col, f.rule, f.message


# -- rule registry -----------------------------------------------------


@dataclass
class Rule:
    name: str
    doc: str
    check: Callable[["LintContext"], Iterable[Finding]]
    default_enabled: bool = True


RULES: dict[str, Rule] = {}


def rule(name: str, *, default_enabled: bool = True):
    """Register a rule. The decorated callable receives a
    :class:`LintContext` and yields :class:`Finding` objects; its
    docstring's first line becomes the rule's one-line description in
    ``--list-rules`` and the docs table."""

    def deco(fn: Callable[["LintContext"], Iterable[Finding]]):
        if name in RULES:
            raise ValueError(f"duplicate rule name {name!r}")
        doc = (fn.__doc__ or "").strip().splitlines()
        RULES[name] = Rule(name, doc[0] if doc else "", fn, default_enabled)
        return fn

    return deco


def _load_rules() -> None:
    """Import the rule modules exactly once (registration side effect)."""
    if getattr(_load_rules, "_done", False):
        return
    from spark_bagging_tpu_torch.analysis import rules  # noqa: F401

    _load_rules._done = True  # type: ignore[attr-defined]


# -- suppressions ------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*sbt-lint:\s*disable=([\w\-, ]+)")
_MARKER_RE = re.compile(r"#\s*sbt-lint:\s*([\w\-]+)\s*(?:$|[^=\w])")


def _parse_suppressions(lines: list[str]) -> dict[int, set[str]]:
    """Map 1-based line number -> suppressed rule names (``{"all"}``
    wildcards). A suppression on a comment-only line also covers the
    next line, so long statements can carry the comment above them."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        names = {n.strip() for n in m.group(1).split(",") if n.strip()}
        out.setdefault(i, set()).update(names)
        if text.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(names)
    return out


def _parse_markers(lines: list[str]) -> dict[int, set[str]]:
    """Non-suppression markers (``# sbt-lint: shared-state``) by line;
    a marker on a comment-only line also tags the next line (so it can
    sit directly above a ``class`` statement)."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _MARKER_RE.search(text)
        if not m or m.group(1) == "disable":
            continue
        out.setdefault(i, set()).add(m.group(1))
        if text.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).add(m.group(1))
    return out


# -- shared AST helpers ------------------------------------------------

#: parsed modules by (path, source), and each one's nodes by the
#: tree's id: the four engines of one CLI run read the same files, and
#: parsing and walking them is most of their cost
_TREES: dict[tuple[str, str], ast.Module] = {}
_NODES: dict[int, list[ast.AST]] = {}
_TREES_MAX = 1024


def parse(source: str, path: str = "<string>") -> ast.Module:
    """``ast.parse`` memoized on (path, source); no engine mutates a
    tree. Raises SyntaxError as ``ast.parse`` does."""
    key = (path, source)
    tree = _TREES.get(key)
    if tree is None:
        if len(_TREES) >= _TREES_MAX:
            _TREES.clear()
            _NODES.clear()
        tree = _TREES[key] = ast.parse(source, filename=path)
    return tree


def module_nodes(tree: ast.Module) -> list[ast.AST]:
    """Every node of a tree :func:`parse` returned, in ``ast.walk``
    order, walked once for every engine."""
    nodes = _NODES.get(id(tree))
    if nodes is None or (nodes and nodes[0] is not tree):
        nodes = _NODES[id(tree)] = list(ast.walk(tree))
    return nodes



def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_skip_defs(node: ast.AST) -> Iterator[ast.AST]:
    """Yield descendants WITHOUT entering nested function/class defs —
    the lexical-scope walk most rules want."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef,
                    ast.ClassDef, ast.Lambda)
        ):
            yield from walk_skip_defs(child)


# -- context -----------------------------------------------------------


@dataclass
class LintContext:
    """Everything a rule needs about one source file."""

    path: str
    source: str
    tree: ast.Module
    lines: list[str]
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    markers: dict[int, set[str]] = field(default_factory=dict)
    _cache: dict[str, Any] = field(default_factory=dict)

    def finding(self, rule_name: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule_name, self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, message)

    def suppressed(self, f: Finding) -> bool:
        for line in (f.line, self._stmt_starts().get(f.line)):
            if line is None:
                continue
            names = self.suppressions.get(line, ())
            if f.rule in names or "all" in names:
                return True
        return False

    def _stmt_starts(self) -> dict[int, int]:
        """Line -> first line of the smallest enclosing SIMPLE statement
        (compound statements map their header lines only). Findings
        anchored deep inside a wrapped multi-line statement stay
        suppressible by a comment on/above the statement's first line,
        so a formatter re-wrap cannot orphan a suppression."""
        cached = self._cache.get("stmt_starts")
        if cached is not None:
            return cached
        starts: dict[int, int] = {}
        compound = (ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                    ast.AsyncWith, ast.Try, ast.FunctionDef,
                    ast.AsyncFunctionDef, ast.ClassDef)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            end = getattr(node, "end_lineno", node.lineno)
            if isinstance(node, compound):
                body = getattr(node, "body", None)
                if body:
                    end = body[0].lineno - 1
            for line in range(node.lineno, end + 1):
                # innermost statement wins: later (nested) walk visits
                # overwrite only when they start no earlier
                if line not in starts or starts[line] < node.lineno:
                    starts[line] = node.lineno
        self._cache["stmt_starts"] = starts
        return starts

    def nodes(self) -> list[ast.AST]:
        """Every node of the module in ``ast.walk`` order, walked once
        for all the rules that scan the whole file."""
        return module_nodes(self.tree)

    def marked(self, node: ast.AST, marker: str) -> bool:
        return marker in self.markers.get(getattr(node, "lineno", -1), ())


# -- running -----------------------------------------------------------


def lint_source(
    source: str,
    path: str = "<string>",
    *,
    enabled: Iterable[str] | None = None,
    disabled: Iterable[str] = (),
) -> list[Finding]:
    """Lint one source string. ``enabled=None`` runs every registered
    rule (minus ``disabled``); otherwise only the named rules run."""
    _load_rules()
    try:
        tree = parse(source, path)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 1,
                        (e.offset or 0) + 1, f"cannot parse: {e.msg}")]
    lines = source.splitlines()
    ctx = LintContext(
        path=path, source=source, tree=tree, lines=lines,
        suppressions=_parse_suppressions(lines),
        markers=_parse_markers(lines),
    )
    names = set(RULES) if enabled is None else set(enabled)
    names -= set(disabled)
    findings: list[Finding] = []
    for name in sorted(names):
        r = RULES.get(name)
        if r is None:
            raise KeyError(
                f"unknown rule {name!r}; known: {sorted(RULES)}"
            )
        findings.extend(f for f in r.check(ctx) if not ctx.suppressed(f))
    # rules may reach one node through two walk paths; report it once
    findings = sorted(set(findings), key=finding_order)
    return findings


def lint_file(path: str, **kw: Any) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path, **kw)


def iter_python_files(paths: Iterable[str],
                      exclude: Iterable[str] = ()) -> Iterator[str]:
    """Expand files/dirs into .py files, skipping excluded fragments
    (glob patterns matched against the normalized relative path)."""
    patterns = list(exclude)

    def excluded(p: str) -> bool:
        norm = p.replace(os.sep, "/")
        return any(
            fnmatch.fnmatch(norm, pat) or fnmatch.fnmatch(norm, f"*/{pat}")
            or f"/{pat.strip('/')}/" in f"/{norm}/"
            for pat in patterns
        )

    for p in paths:
        if os.path.isfile(p):
            if not excluded(p):
                yield p
        elif not os.path.isdir(p):
            # a typo'd path silently linting NOTHING would make a CI
            # gate pass while the tree rots — fail loudly instead
            raise FileNotFoundError(f"lint path does not exist: {p!r}")
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d != "__pycache__" and not excluded(os.path.join(root, d))
                )
                for f in sorted(files):
                    fp = os.path.join(root, f)
                    if f.endswith(".py") and not excluded(fp):
                        yield fp


def lint_paths(
    paths: Iterable[str],
    *,
    exclude: Iterable[str] = (),
    disabled: Iterable[str] = (),
) -> list[Finding]:
    findings: list[Finding] = []
    for fp in iter_python_files(paths, exclude):
        findings.extend(lint_file(fp, disabled=disabled))
    return findings


# -- config ------------------------------------------------------------

DEFAULT_CONFIG = {
    "paths": ["spark_bagging_tpu_torch", "chip_smoke.py"],
    "exclude": [],
    "disable": [],
    # Engine selection for the unified CLI; empty means "all engines".
    "engines": [],
}


def load_config(root: str = ".") -> dict[str, Any]:
    """``[tool.sbt-lint-torch]`` from ``<root>/pyproject.toml`` layered
    over the port's defaults; missing file or section means pure
    defaults. ``[tool.sbt-lint]`` configures the reference package and
    is not read."""
    cfg = {k: list(v) for k, v in DEFAULT_CONFIG.items()}
    pp = os.path.join(root, "pyproject.toml")
    if not os.path.isfile(pp):
        return cfg
    try:
        import tomllib  # py >= 3.11
    except ImportError:
        try:
            import tomli as tomllib  # type: ignore[no-redef]
        except ImportError:
            return cfg
    with open(pp, "rb") as fh:
        data = tomllib.load(fh)
    section = data.get("tool", {}).get("sbt-lint-torch", {})
    for key in cfg:
        if key in section:
            cfg[key] = list(section[key])
    return cfg


# -- reporters ---------------------------------------------------------


def render_text(findings: list[Finding]) -> str:
    if not findings:
        return "sbt-lint: clean\n"
    body = "\n".join(f.render() for f in findings)
    return f"{body}\nsbt-lint: {len(findings)} finding(s)\n"


def render_json(findings: list[Finding]) -> str:
    return json.dumps(
        [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "col": f.col, "message": f.message}
            for f in findings
        ],
        indent=2,
    ) + "\n"
