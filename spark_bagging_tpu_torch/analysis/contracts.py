"""Cross-artifact contract engine — the port's registries, tables, and
docs that keep each other honest, checked as one whole-repo pass.

The port's observability and chaos planes are built on REGISTRIES:
``SERIES_HELP`` documents every metric series, ``faults.SITES`` names
every injection point, the flight recorder's ``TRIGGER_KINDS`` name
every dump trigger, and the route and verdict tables in README.md's
"PyTorch / H100 port" section document every HTTP endpoint and tail
verdict. Each registry has a *counterpart* in the code (emit sites,
``fire()`` call sites, route dispatch), and the two drift
independently: a new ``telemetry.inc`` with no help entry is an
undocumented instrument; a ``SITES`` key nobody fires is a dead entry
in the documented fault surface; a served route missing from the docs
table is an API nobody can find. This engine checks them all, and the
CLI + tier-1 gate run the full inventory.

Checks (``CONTRACT_CHECKS``; each name is also its finding rule):

- ``contract-series-help`` — every ``sbt_*`` string literal in the
  port and ``chip_smoke.py`` has a ``SERIES_HELP`` entry (or rides the
  ``sbt_fit_`` dynamic prefix); and — the reverse — every
  ``SERIES_HELP`` entry is emitted somewhere (no dead documentation).
- ``contract-series-twins`` — series documented as "unlabeled total +
  label X" keep BOTH emit forms alive (an unlabeled ``inc(name)`` and
  a labeled ``inc(name, labels=...)``).
- ``contract-fault-sites`` — ``faults.fire("x")`` call sites ↔
  ``faults.SITES`` keys, two-way. The only exemption is the port's
  declared ``faults.UNPORTED_SITES``: seams of the reference package
  whose code the port does not have (the AOT executable files), kept
  in ``SITES`` so a plan naming them still loads.
- ``contract-recorder-kinds`` — every flight-recorder
  ``TRIGGER_KINDS``/``TIMELINE_KINDS`` entry has a live emit site (a
  ``{"kind": ...}`` event literal somewhere in the port).
- ``contract-alert-rules`` — every ``AlertRule`` built by a
  ``default_*_rules()`` factory references a series that exists in
  ``SERIES_HELP``.
- ``contract-http-routes`` — routes served by ``telemetry/server.py``
  ↔ the README.md route table ↔ the server's own ``/`` index list,
  all two-way.
- ``contract-tail-verdicts`` — ``telemetry/perf.py`` ``VERDICTS`` ↔
  the README.md verdict table, two-way.

The reference package's scenario-baseline check has no counterpart:
the port has no scenario registry.

All extraction is STATIC — dict/tuple literals are read from the AST,
never imported — so the engine runs without torch, in milliseconds,
and a syntax-broken registry file fails loudly instead of importing
half a package. Pure stdlib.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

from spark_bagging_tpu_torch.analysis.lint import (
    Finding,
    dotted_name,
    finding_order,
    module_nodes,
    parse,
)

__all__ = [
    "CONTRACT_CHECKS",
    "RepoContext",
    "check_repo",
    "contract_check",
]

# -- repo context ------------------------------------------------------


@dataclass
class RepoContext:
    """Parsed view of the repo the checks share: file list, AST cache,
    and the statically-extracted registries."""

    root: str
    _asts: dict[str, ast.Module] = field(default_factory=dict)
    _sources: dict[str, str] = field(default_factory=dict)

    # -- file access ---------------------------------------------------

    def path(self, *rel: str) -> str:
        return os.path.join(self.root, *rel)

    def rel(self, path: str) -> str:
        return os.path.relpath(path, self.root)

    def source(self, relpath: str) -> str:
        if relpath not in self._sources:
            with open(self.path(relpath), encoding="utf-8") as fh:
                self._sources[relpath] = fh.read()
        return self._sources[relpath]

    def tree(self, relpath: str) -> ast.Module:
        if relpath not in self._asts:
            self._asts[relpath] = parse(self.source(relpath), relpath)
        return self._asts[relpath]

    def nodes(self, relpath: str) -> list[ast.AST]:
        """Every node of ``relpath`` in ``ast.walk`` order, walked once
        for all the checks."""
        return module_nodes(self.tree(relpath))

    def python_files(self, *roots: str) -> Iterator[str]:
        """Relative paths of every .py file under the given repo-
        relative roots (sorted — findings must be deterministic)."""
        for r in roots:
            top = self.path(r)
            if os.path.isfile(top):
                yield r
                continue
            for dirpath, dirnames, files in os.walk(top):
                dirnames[:] = sorted(
                    d for d in dirnames if d != "__pycache__"
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield self.rel(os.path.join(dirpath, f))

    # -- static registry extraction ------------------------------------

    def assigned_literal(self, relpath: str, name: str) -> ast.expr:
        """The value expression of the module-level ``NAME = ...``
        assignment (Assign or AnnAssign) in ``relpath``."""
        for node in self.tree(relpath).body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == name:
                    if node.value is None:
                        break
                    return node.value
        raise KeyError(f"no module-level `{name} = ...` in {relpath}")

    def dict_keys(self, relpath: str, name: str) -> dict[str, int]:
        """String keys of a module-level dict literal -> line number."""
        value = self.assigned_literal(relpath, name)
        if not isinstance(value, ast.Dict):
            raise TypeError(f"{name} in {relpath} is not a dict literal")
        return {
            k.value: k.lineno for k in value.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }

    def dict_items(self, relpath: str, name: str) -> dict[str, str]:
        """String keys -> string values of a module-level dict."""
        value = self.assigned_literal(relpath, name)
        out: dict[str, str] = {}
        for k, v in zip(value.keys, value.values):
            if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                out[k.value] = v.value
        return out

    def tuple_strings(self, relpath: str, name: str) -> list[str]:
        """Resolve a module-level tuple-of-strings assignment,
        following one level of ``OTHER + (...)`` concatenation (the
        ``TIMELINE_KINDS = TRIGGER_KINDS + (...)`` idiom) and bare
        Name references to other module-level string constants."""
        def resolve(expr: ast.expr) -> list[str]:
            if isinstance(expr, (ast.Tuple, ast.List)):
                out = []
                for el in expr.elts:
                    out.extend(resolve(el))
                return out
            if isinstance(expr, ast.Constant) and isinstance(
                    expr.value, str):
                return [expr.value]
            if isinstance(expr, ast.BinOp) and isinstance(
                    expr.op, ast.Add):
                return resolve(expr.left) + resolve(expr.right)
            if isinstance(expr, ast.Name):
                return resolve(
                    self.assigned_literal(relpath, expr.id)
                )
            raise TypeError(
                f"cannot statically resolve {ast.dump(expr)} "
                f"for {name} in {relpath}"
            )
        return resolve(self.assigned_literal(relpath, name))


# -- check registry ----------------------------------------------------

CONTRACT_CHECKS: dict[str, tuple[str, Callable]] = {}


def contract_check(name: str):
    """Register a contract check: the callable receives a
    :class:`RepoContext` and yields :class:`Finding` objects; the
    docstring's first line is the --list-rules description."""

    def deco(fn: Callable[[RepoContext], Iterable[Finding]]):
        if name in CONTRACT_CHECKS:
            raise ValueError(f"duplicate contract check {name!r}")
        doc = (fn.__doc__ or "").strip().splitlines()
        CONTRACT_CHECKS[name] = (doc[0] if doc else "", fn)
        return fn

    return deco


def _finding(name: str, path: str, line: int, message: str) -> Finding:
    return Finding(name, path, line, 1, message)


# -- shared extraction helpers -----------------------------------------

_PKG = "spark_bagging_tpu_torch"
_REGISTRY_PY = os.path.join(_PKG, "telemetry", "registry.py")
_FAULTS_PY = os.path.join(_PKG, "faults.py")
_RECORDER_PY = os.path.join(_PKG, "telemetry", "recorder.py")
_ALERTS_PY = os.path.join(_PKG, "telemetry", "alerts.py")
_SERVER_PY = os.path.join(_PKG, "telemetry", "server.py")
_PERF_PY = os.path.join(_PKG, "telemetry", "perf.py")
#: the port's tables live in one section of README.md (ARCHITECTURE.md
#: documents the reference package)
_DOCS_MD = "README.md"
_DOCS_SECTION = "## PyTorch / H100 port"

#: where sbt_* literals and emit sites are looked for
_SERIES_SCOPE = (_PKG, "chip_smoke.py")

_SBT_SERIES_RE = re.compile(r'["\'](sbt_[a-z0-9_]+)["\']')


def _series_literals(ctx: RepoContext) -> dict[str, tuple[str, int]]:
    """Every ``sbt_*`` series literal in scope -> first (path, line).
    Prefix fragments (trailing underscore) are skipped, as the
    original walk did. The SERIES_HELP dict's own span is excluded:
    a key's appearance in its own documentation table must not count
    as a live use, or the dead-docs direction could never fire."""
    try:
        help_dict = ctx.assigned_literal(_REGISTRY_PY, "SERIES_HELP")
        skip = (help_dict.lineno, help_dict.end_lineno or help_dict.lineno)
    except (KeyError, OSError, SyntaxError):
        skip = None
    out: dict[str, tuple[str, int]] = {}
    for relpath in ctx.python_files(*_SERIES_SCOPE):
        in_registry = relpath == _REGISTRY_PY
        for i, text in enumerate(ctx.source(relpath).splitlines(), 1):
            if in_registry and skip and skip[0] <= i <= skip[1]:
                continue
            for name in _SBT_SERIES_RE.findall(text):
                if name.endswith("_"):
                    continue
                out.setdefault(name, (relpath, i))
    return out


def _emit_calls(ctx: RepoContext) -> Iterator[tuple[str, ast.Call]]:
    """(relpath, Call) for every telemetry emit-style call (``inc``/
    ``observe``/``set``/``set_gauge``) with a string series name."""
    for relpath in ctx.python_files(*_SERIES_SCOPE):
        for node in ctx.nodes(relpath):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            last = (name or "").rsplit(".", 1)[-1]
            if last not in ("inc", "observe", "set", "set_gauge"):
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield relpath, node


# -- the checks --------------------------------------------------------


@contract_check("contract-series-help")
def series_help(ctx: RepoContext) -> Iterator[Finding]:
    """every sbt_* literal has a SERIES_HELP entry, and every entry is
    emitted somewhere (no undocumented instruments, no dead docs)"""
    help_keys = ctx.dict_keys(_REGISTRY_PY, "SERIES_HELP")
    literals = _series_literals(ctx)
    for name, (path, line) in sorted(literals.items()):
        if name.startswith("sbt_fit_"):
            continue  # the dynamic-prefix family gets prefix help
        if name not in help_keys:
            yield _finding(
                "contract-series-help", path, line,
                f"series {name!r} has no SERIES_HELP entry in "
                "telemetry/registry.py — an undocumented instrument "
                "(a scraper's UI shows help next to the graph)",
            )
    for name, line in sorted(help_keys.items()):
        if name not in literals:
            yield _finding(
                "contract-series-help", _REGISTRY_PY, line,
                f"SERIES_HELP entry {name!r} has no emit site anywhere "
                "in the tree — dead documentation; delete the entry or "
                "wire the instrument back up",
            )


@contract_check("contract-series-twins")
def series_twins(ctx: RepoContext) -> Iterator[Finding]:
    """series documented "unlabeled total + label X" keep both the
    unlabeled and the labeled emit form alive"""
    items = ctx.dict_items(_REGISTRY_PY, "SERIES_HELP")
    twins = {k for k, v in items.items()
             if "unlabeled total + label" in v}
    if not twins:
        return
    unlabeled: dict[str, tuple[str, int]] = {}
    labeled: dict[str, tuple[str, int]] = {}
    for relpath, call in _emit_calls(ctx):
        name = call.args[0].value
        if name not in twins:
            continue
        has_labels = any(kw.arg == "labels" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ) for kw in call.keywords)
        side = labeled if has_labels else unlabeled
        side.setdefault(name, (relpath, call.lineno))
    help_lines = ctx.dict_keys(_REGISTRY_PY, "SERIES_HELP")
    for name in sorted(twins):
        if name not in unlabeled:
            yield _finding(
                "contract-series-twins", _REGISTRY_PY,
                help_lines[name],
                f"{name!r} is documented as an unlabeled+labeled twin "
                "but no UNLABELED emit site exists — the fleet-merge "
                "total would silently read 0",
            )
        if name not in labeled:
            yield _finding(
                "contract-series-twins", _REGISTRY_PY,
                help_lines[name],
                f"{name!r} is documented as an unlabeled+labeled twin "
                "but no LABELED emit site exists — the per-key "
                "breakdown the help promises is gone",
            )


def _unported_sites(ctx: RepoContext) -> dict[str, int]:
    """``faults.UNPORTED_SITES`` (a tuple of strings) -> its line; empty
    when the module declares none."""
    try:
        value = ctx.assigned_literal(_FAULTS_PY, "UNPORTED_SITES")
    except KeyError:
        return {}
    return {site: value.lineno
            for site in ctx.tuple_strings(_FAULTS_PY, "UNPORTED_SITES")}


@contract_check("contract-fault-sites")
def fault_sites(ctx: RepoContext) -> Iterator[Finding]:
    """faults.fire() call sites and faults.SITES keys match two-way
    (faults.UNPORTED_SITES the only exemption)"""
    sites = ctx.dict_keys(_FAULTS_PY, "SITES")
    unported = _unported_sites(ctx)
    fired: dict[str, tuple[str, int]] = {}
    for relpath in ctx.python_files(_PKG):
        if relpath == _FAULTS_PY:
            continue  # faults.py defines the probe, it doesn't fire it
        for node in ctx.nodes(relpath):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            if name.rsplit(".", 1)[-1] != "fire":
                continue
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                fired.setdefault(node.args[0].value,
                                 (relpath, node.lineno))
    for site, (path, line) in sorted(fired.items()):
        if site not in sites:
            yield _finding(
                "contract-fault-sites", path, line,
                f"faults.fire({site!r}) has no faults.SITES entry — "
                "a silent no-op plan key mid-incident",
            )
    for site, line in sorted(unported.items()):
        if site not in sites:
            yield _finding(
                "contract-fault-sites", _FAULTS_PY, line,
                f"faults.UNPORTED_SITES names {site!r}, which is not a "
                "faults.SITES key — the exemption covers nothing",
            )
        elif site in fired:
            path, fired_line = fired[site]
            yield _finding(
                "contract-fault-sites", path, fired_line,
                f"faults.fire({site!r}) fires a seam declared in "
                "faults.UNPORTED_SITES — drop the declaration",
            )
    for site, line in sorted(sites.items()):
        if site not in fired and site not in unported:
            yield _finding(
                "contract-fault-sites", _FAULTS_PY, line,
                f"faults.SITES entry {site!r} has no live fire() call "
                "site — a dead entry in the documented fault surface",
            )


@contract_check("contract-recorder-kinds")
def recorder_kinds(ctx: RepoContext) -> Iterator[Finding]:
    """every flight-recorder TRIGGER/TIMELINE kind has a live emit
    site (a {"kind": ...} event literal in the package)"""
    emitted: set[str] = set()
    for relpath in ctx.python_files(_PKG):
        for node in ctx.nodes(relpath):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "kind"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    emitted.add(v.value)
    for table in ("TRIGGER_KINDS", "TIMELINE_KINDS"):
        kinds = ctx.tuple_strings(_RECORDER_PY, table)
        value = ctx.assigned_literal(_RECORDER_PY, table)
        for kind in kinds:
            if kind not in emitted:
                yield _finding(
                    "contract-recorder-kinds", _RECORDER_PY,
                    value.lineno,
                    f"{table} entry {kind!r} is never emitted as a "
                    '`{"kind": ...}` event anywhere in the package — '
                    "the recorder waits for a trigger that cannot fire",
                )


@contract_check("contract-alert-rules")
def alert_rules(ctx: RepoContext) -> Iterator[Finding]:
    """every AlertRule built by a default_*_rules() factory references
    a series that exists in SERIES_HELP"""
    help_keys = ctx.dict_keys(_REGISTRY_PY, "SERIES_HELP")
    for node in ast.walk(ctx.tree(_ALERTS_PY)):
        if not isinstance(node, ast.FunctionDef):
            continue
        if not re.match(r"^default_\w+_rules$", node.name):
            continue
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            if dotted_name(call.func) != "AlertRule":
                continue
            if len(call.args) < 2:
                continue
            series = call.args[1]
            if not (isinstance(series, ast.Constant)
                    and isinstance(series.value, str)):
                continue
            name = series.value
            if name not in help_keys and not name.startswith("sbt_fit_"):
                yield _finding(
                    "contract-alert-rules", _ALERTS_PY, series.lineno,
                    f"{node.name}() builds a rule over {name!r}, which "
                    "has no SERIES_HELP entry — the rule watches a "
                    "series that does not exist",
                )


def _served_routes(ctx: RepoContext) -> dict[str, int]:
    """Routes the server dispatches: ``url.path == "/x"`` compares
    plus the ``/fleet/<sub>`` subroutes dispatched inside ``_fleet``."""
    routes: dict[str, int] = {}
    tree = ctx.tree(_SERVER_PY)
    fleet_fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_fleet":
            fleet_fn = node
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        left = dotted_name(node.left)
        if left not in ("url.path",):
            continue
        for comp in node.comparators:
            if isinstance(comp, ast.Constant) and isinstance(
                    comp.value, str) and comp.value.startswith("/"):
                if comp.value != "/":
                    routes.setdefault(comp.value, comp.lineno)
    if fleet_fn is not None:
        for node in ast.walk(fleet_fn):
            if not isinstance(node, ast.Compare):
                continue
            if not (isinstance(node.left, ast.Name)
                    and node.left.id == "route"):
                continue
            for comp in node.comparators:
                if isinstance(comp, ast.Constant) and isinstance(
                        comp.value, str):
                    routes.setdefault(f"/fleet/{comp.value}",
                                      comp.lineno)
    return routes


def _index_routes(ctx: RepoContext) -> set[str]:
    """The ``/`` index endpoint's advertised list."""
    for node in ast.walk(ctx.tree(_SERVER_PY)):
        if not isinstance(node, ast.Dict):
            continue
        for k, v in zip(node.keys, node.values):
            if (isinstance(k, ast.Constant) and k.value == "endpoints"
                    and isinstance(v, ast.List)):
                return {
                    el.value for el in v.elts
                    if isinstance(el, ast.Constant)
                    and isinstance(el.value, str)
                }
    return set()


def _section_lines(ctx: RepoContext) -> list[tuple[int, str]]:
    """(line number, text) of README.md's port section: from its
    ``## PyTorch / H100 port`` heading to the next level-2 heading."""
    out: list[tuple[int, str]] = []
    inside = False
    for i, text in enumerate(ctx.source(_DOCS_MD).splitlines(), 1):
        if text.startswith("## "):
            inside = text.strip() == _DOCS_SECTION
            continue
        if inside:
            out.append((i, text))
    return out


def _documented_routes(ctx: RepoContext) -> dict[str, int]:
    """First-cell backticked routes of the port section's table whose
    header row is ``| route | serves | semantics |``."""
    out: dict[str, int] = {}
    in_table = False
    for i, text in _section_lines(ctx):
        stripped = text.strip()
        if re.match(r"^\|\s*route\s*\|", stripped):
            in_table = True
            continue
        if in_table:
            if not stripped.startswith("|"):
                in_table = False
                continue
            m = re.match(r"^\|\s*`(/[^`]*)`", stripped)
            if m:
                out.setdefault(m.group(1), i)
    return out


@contract_check("contract-http-routes")
def http_routes(ctx: RepoContext) -> Iterator[Finding]:
    """telemetry/server.py routes ↔ the README.md route table ↔
    the server's own / index list, two-way"""
    served = _served_routes(ctx)
    documented = _documented_routes(ctx)
    index = _index_routes(ctx)
    if not documented:
        yield _finding(
            "contract-http-routes", _DOCS_MD, 1,
            "could not locate the `| route | serves | semantics |` "
            "table — the route-contract check has nothing to verify",
        )
        return
    for route, line in sorted(served.items()):
        if route not in documented:
            yield _finding(
                "contract-http-routes", _SERVER_PY, line,
                f"served route {route!r} is missing from the "
                "README.md route table — an undocumented API",
            )
        if route not in index:
            yield _finding(
                "contract-http-routes", _SERVER_PY, line,
                f"served route {route!r} is missing from the server's "
                "own `/` index list — undiscoverable from the process",
            )
    for route, line in sorted(documented.items()):
        if route not in served:
            yield _finding(
                "contract-http-routes", _DOCS_MD, line,
                f"documented route {route!r} is not dispatched by "
                "telemetry/server.py — the docs promise an endpoint "
                "that 404s",
            )
    for route in sorted(index - set(served)):
        yield _finding(
            "contract-http-routes", _SERVER_PY, 1,
            f"index-advertised route {route!r} is not dispatched — "
            "the server advertises an endpoint that 404s",
        )


def _documented_verdicts(ctx: RepoContext) -> dict[str, int]:
    """First-cell backticked verdicts of the port section's table whose
    header row is ``| verdict | evidence |``."""
    out: dict[str, int] = {}
    in_table = False
    for i, text in _section_lines(ctx):
        stripped = text.strip()
        if re.match(r"^\|\s*verdict\s*\|", stripped):
            in_table = True
            continue
        if in_table:
            if not stripped.startswith("|"):
                in_table = False
                continue
            m = re.match(r"^\|\s*`([a-z][a-z-]*)`", stripped)
            if m:
                out.setdefault(m.group(1), i)
    return out


@contract_check("contract-tail-verdicts")
def tail_verdicts(ctx: RepoContext) -> Iterator[Finding]:
    """telemetry/perf.py VERDICTS ↔ the README.md
    `| verdict | evidence |` ladder table, two-way"""
    verdicts = ctx.tuple_strings(_PERF_PY, "VERDICTS")
    value = ctx.assigned_literal(_PERF_PY, "VERDICTS")
    documented = _documented_verdicts(ctx)
    if not documented:
        yield _finding(
            "contract-tail-verdicts", _DOCS_MD, 1,
            "could not locate the `| verdict | evidence |` table — "
            "the tail-verdict contract check has nothing to verify",
        )
        return
    for v in verdicts:
        if v not in documented:
            yield _finding(
                "contract-tail-verdicts", _PERF_PY, value.lineno,
                f"tail verdict {v!r} is missing from the "
                "README.md verdict-ladder table — an operator "
                "reading /debug/tail meets a verdict the docs never "
                "explain",
            )
    for v, line in sorted(documented.items()):
        if v not in verdicts:
            yield _finding(
                "contract-tail-verdicts", _DOCS_MD, line,
                f"documented verdict {v!r} is not in "
                "telemetry/perf.py VERDICTS — the docs promise an "
                "explanation correlate_tail can never emit",
            )


# -- running -----------------------------------------------------------


def check_repo(
    root: str,
    *,
    checks: Iterable[str] | None = None,
    disabled: Iterable[str] = (),
) -> list[Finding]:
    """Run the contract inventory over a repo tree. ``checks=None``
    runs every registered check minus ``disabled``."""
    names = set(CONTRACT_CHECKS) if checks is None else set(checks)
    unknown = names - set(CONTRACT_CHECKS)
    if unknown:
        raise KeyError(
            f"unknown contract check(s) {sorted(unknown)}; "
            f"known: {sorted(CONTRACT_CHECKS)}"
        )
    names -= set(disabled)
    ctx = RepoContext(root=root)
    findings: list[Finding] = []
    for name in sorted(names):
        _doc, fn = CONTRACT_CHECKS[name]
        findings.extend(fn(ctx))
    return sorted(set(findings), key=finding_order)
