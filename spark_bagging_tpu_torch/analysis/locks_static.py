"""Static extraction of the ``make_lock`` acquisition graph.

The dynamic detector in :mod:`spark_bagging_tpu_torch.analysis.locks`
only sees the lock orders a particular run happens to exercise; a rare
code path (an eviction inside a refit inside a scrape) can hide an
inversion for weeks.  This pass recovers the acquisition graph from source instead:

* every ``make_lock("dotted.name")`` assignment is a node — class
  attribute locks (``self._lock = make_lock(...)`` anywhere in the
  class body) and module-level locks alike;
* ``with self._lock:`` nesting inside one function yields a direct
  edge ``outer -> inner``;
* one level of call-graph propagation: a call made while holding lock
  ``A``, when it resolves to a function whose body acquires ``B``,
  yields ``A -> B``.  Resolution is deliberately conservative — only
  calls we can pin to a unique definition count (``self.m()``,
  same-module functions, ``alias.fn()`` through package imports,
  chained calls through return annotations such as
  ``_pc.cache().get(...)``, and ``self._attr.m()`` where ``__init__``
  reveals the attribute's class).  Unresolvable calls contribute no
  edges; the graph is an over-approximation of orders *we can prove*,
  not of every order possible, which is why the agreement test checks
  ``dynamic observed ⊆ static`` and not equality.

Findings (all suppressible with the usual ``# sbt-lint: disable=``):

* ``static-lock-inversion`` — a cycle in the acquisition graph; two
  threads walking the cycle from different entry points deadlock.
* ``static-nested-same-lock`` — a non-reentrant lock re-acquired while
  already held (directly, or through a resolved call); this
  self-deadlocks on first execution.
* ``static-unlocked-check-then-act`` — a method tests ``self.attr``
  and writes it in the same method with no lock held, while the same
  attribute is lock-guarded elsewhere in the class.  This is the
  ``MicroBatcher.close()`` double-drain bug class, found statically.

Pure stdlib; safe to run anywhere (never imports the code it reads).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Iterable

from spark_bagging_tpu_torch.analysis.lint import (
    Finding,
    LintContext,
    _parse_markers,
    _parse_suppressions,
    dotted_name,
    finding_order,
    iter_python_files,
    parse,
)

# -- rule registry -----------------------------------------------------

LOCK_RULES: dict[str, str] = {
    "static-lock-inversion":
        "cycle in the static make_lock acquisition graph (deadlock "
        "under contention)",
    "static-nested-same-lock":
        "non-reentrant make_lock re-acquired while already held "
        "(self-deadlock)",
    "static-unlocked-check-then-act":
        "check-then-act on a lock-guarded attribute with no lock held "
        "(the MicroBatcher.close bug class)",
}

_PACKAGE = "spark_bagging_tpu_torch"

# Identifier harvested from a return annotation ("ProgramCache | None",
# Optional["Registry"], ...) — first name that isn't typing noise.
_ANNOT_NOISE = {"None", "Optional", "Union", "Any", "Iterable", "Iterator",
                "list", "dict", "tuple", "set", "str", "int", "float",
                "bool", "bytes", "Callable", "Sequence", "Mapping"}
_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


# -- index structures --------------------------------------------------


@dataclass(frozen=True)
class LockDecl:
    """One ``make_lock`` assignment: the runtime dotted name plus where
    and under which variable it lives."""

    name: str      # runtime name, e.g. "serving.program_cache"
    var: str       # attribute / module variable it is bound to
    rlock: bool
    path: str
    line: int


@dataclass
class _Func:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    module: "_Module"
    cls: "_Class | None"
    returns_class: str | None
    # Lock names this function's own body acquires via ``with`` (not
    # through calls) — the payload of one-level propagation.
    direct_acquires: set[str] = field(default_factory=set)

    @property
    def qualname(self) -> str:
        if self.cls is not None:
            return f"{self.cls.name}.{self.node.name}"
        return self.node.name


@dataclass
class _Class:
    name: str
    module: "_Module"
    lock_attrs: dict[str, LockDecl] = field(default_factory=dict)
    methods: dict[str, _Func] = field(default_factory=dict)
    # self attribute -> bare class name, recovered from __init__
    # (constructor assignment, annotated parameter, or AnnAssign).
    attr_classes: dict[str, str] = field(default_factory=dict)


@dataclass
class _Module:
    path: str
    modname: str
    ctx: LintContext
    # alias -> dotted module
    # ("_pc" -> "spark_bagging_tpu_torch.serving.program_cache")
    imports: dict[str, str] = field(default_factory=dict)
    # alias -> (dotted module, name) for ``from mod import name [as alias]``
    from_names: dict[str, tuple[str, str]] = field(default_factory=dict)
    module_locks: dict[str, LockDecl] = field(default_factory=dict)
    functions: dict[str, _Func] = field(default_factory=dict)
    classes: dict[str, _Class] = field(default_factory=dict)


def _modname(path: str) -> str:
    # derive the dotted name from __init__.py package boundaries, not
    # from relpath: the graph must be identical whatever the caller's
    # working directory is
    norm = os.path.abspath(path)
    if norm.endswith(".py"):
        norm = norm[:-3]
    parts = [os.path.basename(norm)]
    parent = os.path.dirname(norm)
    while os.path.isfile(os.path.join(parent, "__init__.py")):
        parts.append(os.path.basename(parent))
        parent = os.path.dirname(parent)
    name = ".".join(reversed(parts))
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _annotation_class(node: ast.AST | None) -> str | None:
    if node is None:
        return None
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on ast nodes
        return None
    for ident in _IDENT_RE.findall(text):
        if ident not in _ANNOT_NOISE:
            return ident
    return None


def _lock_decl_from_call(call: ast.Call, var: str, path: str) -> LockDecl | None:
    target = dotted_name(call.func)
    if target is None or target.split(".")[-1] != "make_lock":
        return None
    if not call.args or not isinstance(call.args[0], ast.Constant) \
            or not isinstance(call.args[0].value, str):
        return None
    rlock = any(kw.arg == "rlock" and isinstance(kw.value, ast.Constant)
                and bool(kw.value.value) for kw in call.keywords)
    return LockDecl(call.args[0].value, var, rlock, path, call.lineno)


def _index_module(source: str, path: str) -> _Module | None:
    try:
        tree = parse(source, path)
    except SyntaxError:
        return None
    lines = source.splitlines()
    ctx = LintContext(path=path, source=source, tree=tree, lines=lines,
                      suppressions=_parse_suppressions(lines),
                      markers=_parse_markers(lines))
    mod = _Module(path=path, modname=_modname(path), ctx=ctx)
    pkg_parent = mod.modname.rsplit(".", 1)[0] if "." in mod.modname else ""

    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == _PACKAGE:
                    mod.imports[alias.asname or alias.name.split(".")[-1]] \
                        = alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:  # relative import: resolve against our package
                parts = mod.modname.split(".")
                base_parts = parts[: len(parts) - node.level + 1] \
                    if len(parts) >= node.level else []
                base = ".".join(base_parts + ([node.module]
                                              if node.module else []))
            if base.split(".")[0] != _PACKAGE:
                continue
            for alias in node.names:
                bound = alias.asname or alias.name
                # ``from pkg import mod`` and ``from pkg.mod import fn``
                # are indistinguishable here; record both readings and
                # let resolution prefer whichever module actually exists.
                mod.imports.setdefault(bound, f"{base}.{alias.name}")
                mod.from_names[bound] = (base, alias.name)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    decl = _lock_decl_from_call(node.value, tgt.id, path)
                    if decl:
                        mod.module_locks[tgt.id] = decl
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = _Func(
                node, mod, None, _annotation_class(node.returns))
        elif isinstance(node, ast.ClassDef):
            mod.classes[node.name] = _index_class(node, mod)
    # unused but cheap: keep pkg_parent referenced for clarity of intent
    del pkg_parent
    return mod


def _index_class(node: ast.ClassDef, mod: _Module) -> _Class:
    cls = _Class(name=node.name, module=mod)
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        cls.methods[item.name] = _Func(
            item, mod, cls, _annotation_class(item.returns))
        ann_of_param = {a.arg: _annotation_class(a.annotation)
                        for a in (item.args.args + item.args.kwonlyargs)}
        for sub in ast.walk(item):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Attribute) \
                    and isinstance(sub.targets[0].value, ast.Name) \
                    and sub.targets[0].value.id == "self":
                attr = sub.targets[0].attr
                if isinstance(sub.value, ast.Call):
                    decl = _lock_decl_from_call(sub.value, attr, mod.path)
                    if decl:
                        cls.lock_attrs[attr] = decl
                        continue
                    if item.name == "__init__":
                        ctor = dotted_name(sub.value.func)
                        if ctor and ctor[:1].isupper():
                            cls.attr_classes.setdefault(
                                attr, ctor.split(".")[-1])
                elif item.name == "__init__" and isinstance(sub.value,
                                                            ast.Name):
                    ann = ann_of_param.get(sub.value.id)
                    if ann:
                        cls.attr_classes.setdefault(attr, ann)
            elif isinstance(sub, ast.AnnAssign) \
                    and isinstance(sub.target, ast.Attribute) \
                    and isinstance(sub.target.value, ast.Name) \
                    and sub.target.value.id == "self":
                ann = _annotation_class(sub.annotation)
                if ann and item.name == "__init__":
                    cls.attr_classes.setdefault(sub.target.attr, ann)
    return cls


# -- whole-program view ------------------------------------------------


class _Program:
    def __init__(self, modules: list[_Module]):
        self.modules: dict[str, _Module] = {m.modname: m for m in modules}
        # Bare class name -> classes carrying it; resolution requires
        # uniqueness so a generic name never guesses wrong.
        self.class_index: dict[str, list[_Class]] = {}
        for m in modules:
            for cls in m.classes.values():
                self.class_index.setdefault(cls.name, []).append(cls)

    def resolve_class(self, name: str | None) -> _Class | None:
        if not name:
            return None
        hits = self.class_index.get(name, [])
        return hits[0] if len(hits) == 1 else None

    def _module_for_alias(self, mod: _Module, alias: str) -> _Module | None:
        target = mod.imports.get(alias)
        if target and target in self.modules:
            return self.modules[target]
        if target and target.rsplit(".", 1)[0] in self.modules \
                and alias in mod.from_names:
            # ``from pkg import telemetry`` indexed the parent package;
            # the submodule reading wins when it exists.
            sub = self.modules.get(target)
            if sub:
                return sub
        return None

    def resolve_callee(self, call: ast.Call, f: _Func) -> _Func | None:
        """Pin a call site to a unique function definition, or None."""
        fn = call.func
        mod, cls = f.module, f.cls
        if isinstance(fn, ast.Name):
            n = fn.id
            if n in mod.functions:
                return mod.functions[n]
            if n in mod.classes:
                return mod.classes[n].methods.get("__init__")
            if n in mod.from_names:
                src, name = mod.from_names[n]
                target = self.modules.get(src)
                if target:
                    if name in target.functions:
                        return target.functions[name]
                    if name in target.classes:
                        return target.classes[name].methods.get("__init__")
            return None
        if not isinstance(fn, ast.Attribute):
            return None
        meth = fn.attr
        base = fn.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                return cls.methods.get(meth)
            target = self._module_for_alias(mod, base.id)
            if target:
                if meth in target.functions:
                    return target.functions[meth]
                if meth in target.classes:
                    return target.classes[meth].methods.get("__init__")
            if base.id in mod.from_names:
                src, name = mod.from_names[base.id]
                owner = self.modules.get(src)
                if owner and name in owner.classes:
                    return owner.classes[name].methods.get(meth)
            return None
        if isinstance(base, ast.Call):
            inner = self.resolve_callee(base, f)
            if inner is None:
                return None
            if inner.node.name == "__init__" and inner.cls is not None:
                return inner.cls.methods.get(meth)
            k = self.resolve_class(inner.returns_class)
            return k.methods.get(meth) if k else None
        if isinstance(base, ast.Attribute) and isinstance(base.value,
                                                          ast.Name) \
                and base.value.id == "self" and cls is not None:
            k = self.resolve_class(cls.attr_classes.get(base.attr))
            return k.methods.get(meth) if k else None
        return None


# -- per-function scan -------------------------------------------------


@dataclass
class _ScanState:
    """Everything the per-function walk accumulates for later passes."""

    # (a, b) -> first site proving the edge
    edges: dict[tuple[str, str], tuple[str, int]] = field(
        default_factory=dict)
    # calls made while holding at least one lock, for propagation
    calls: list[tuple[_Func, list[LockDecl], ast.Call]] = field(
        default_factory=list)
    findings: list[tuple[_Module, Finding]] = field(default_factory=list)
    # class -> attrs touched under a lock anywhere in the class
    guarded_attrs: dict[int, set[str]] = field(default_factory=dict)
    # (class-id, method) -> [(attr, If node)] tested with no lock held
    unlocked_tests: dict[tuple[int, str], list[tuple[str, ast.stmt]]] = \
        field(default_factory=dict)
    # (class-id, method) -> attrs written with no lock held
    unlocked_writes: dict[tuple[int, str], set[str]] = field(
        default_factory=dict)
    class_by_id: dict[int, _Class] = field(default_factory=dict)

    def add_edge(self, a: str, b: str, path: str, line: int) -> None:
        self.edges.setdefault((a, b), (path, line))


def _lock_of(expr: ast.expr, f: _Func) -> LockDecl | None:
    if isinstance(expr, ast.Name):
        return f.module.module_locks.get(expr.id)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self" and f.cls is not None:
        return f.cls.lock_attrs.get(expr.attr)
    return None


def _self_attrs(node: ast.AST) -> set[str]:
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name) \
                and sub.value.id == "self":
            out.add(sub.attr)
    return out


def _scan_function(f: _Func, state: _ScanState) -> None:
    mod, cls = f.module, f.cls
    in_class_method = cls is not None and f.node.name != "__init__"
    key = (id(cls), f.node.name) if cls is not None else None
    if cls is not None:
        state.class_by_id[id(cls)] = cls
    held: list[LockDecl] = []

    def record_attr_use(node: ast.AST) -> None:
        if cls is None or not held:
            return
        attrs = _self_attrs(node) - set(cls.lock_attrs)
        if attrs:
            state.guarded_attrs.setdefault(id(cls), set()).update(attrs)

    def scan_expr(node: ast.AST | None) -> None:
        # only what runs under a lock feeds the graph and the guarded set
        if node is None or not held:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                state.calls.append((f, list(held), sub))
        record_attr_use(node)

    def visit_block(stmts: list[ast.stmt], nested: bool) -> None:
        for st in stmts:
            visit_stmt(st, nested)

    def visit_stmt(st: ast.stmt, nested: bool) -> None:
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired: list[LockDecl] = []
            for item in st.items:
                scan_expr(item.context_expr)
                decl = _lock_of(item.context_expr, f)
                if decl is None:
                    continue
                if any(h.name == decl.name for h in held) and not decl.rlock:
                    state.findings.append((mod, mod.ctx.finding(
                        "static-nested-same-lock", st,
                        f"'{decl.name}' re-acquired while already held in "
                        f"{f.qualname}; make_lock without rlock=True "
                        f"self-deadlocks here")))
                else:
                    for h in held:
                        if h.name != decl.name:  # rlock re-entry orders nothing
                            state.add_edge(h.name, decl.name, mod.path,
                                           st.lineno)
                if not nested:
                    f.direct_acquires.add(decl.name)
                acquired.append(decl)
                held.append(decl)
            visit_block(st.body, nested)
            for _ in acquired:
                held.pop()
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def runs later, under whatever locks its *caller*
            # holds — not the locks held at definition time.  Scan it
            # with a fresh stack and keep its acquires out of
            # direct_acquires.
            saved, held[:] = list(held), []
            visit_block(st.body, True)
            held[:] = saved
        elif isinstance(st, ast.ClassDef):
            pass
        elif isinstance(st, ast.If):
            scan_expr(st.test)
            if not held and in_class_method and key is not None:
                tested = _self_attrs(st.test) - set(cls.lock_attrs)
                for attr in sorted(tested):
                    state.unlocked_tests.setdefault(key, []).append(
                        (attr, st))
            visit_block(st.body, nested)
            visit_block(st.orelse, nested)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            scan_expr(st.iter)
            visit_block(st.body, nested)
            visit_block(st.orelse, nested)
        elif isinstance(st, ast.While):
            scan_expr(st.test)
            visit_block(st.body, nested)
            visit_block(st.orelse, nested)
        elif isinstance(st, ast.Try):
            visit_block(st.body, nested)
            for handler in st.handlers:
                visit_block(handler.body, nested)
            visit_block(st.orelse, nested)
            visit_block(st.finalbody, nested)
        else:
            scan_expr(st)
            if isinstance(st, (ast.Assign, ast.AugAssign)) and not held \
                    and in_class_method and key is not None:
                targets = st.targets if isinstance(st, ast.Assign) \
                    else [st.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self" \
                            and tgt.attr not in cls.lock_attrs:
                        state.unlocked_writes.setdefault(key, set()).add(
                            tgt.attr)

    visit_block(list(f.node.body), False)


# -- analysis entry points ---------------------------------------------


def _run(modules: list[_Module]) -> tuple[_ScanState, _Program]:
    prog = _Program(modules)
    state = _ScanState()
    for mod in modules:
        for func in mod.functions.values():
            _scan_function(func, state)
        for cls in mod.classes.values():
            for func in cls.methods.values():
                _scan_function(func, state)
    # One level of call-graph propagation.
    for f, held_snapshot, call in state.calls:
        callee = prog.resolve_callee(call, f)
        if callee is None:
            continue
        for acquired in sorted(callee.direct_acquires):
            for h in held_snapshot:
                if acquired == h.name:
                    if not h.rlock:
                        state.findings.append((f.module, f.module.ctx.finding(
                            "static-nested-same-lock", call,
                            f"call to {callee.qualname} re-acquires "
                            f"'{h.name}' already held in {f.qualname}; "
                            f"make_lock without rlock=True self-deadlocks")))
                else:
                    state.add_edge(h.name, acquired, f.module.path,
                                   call.lineno)
    return state, prog


def _cycle_findings(state: _ScanState,
                    modules: dict[str, _Module]) -> None:
    adj: dict[str, list[str]] = {}
    for (a, b) in state.edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    for outs in adj.values():
        outs.sort()
    color: dict[str, int] = {}
    stack: list[str] = []
    reported: set[frozenset[str]] = set()

    def dfs(node: str) -> None:
        color[node] = 1
        stack.append(node)
        for nxt in adj[node]:
            if color.get(nxt, 0) == 0:
                dfs(nxt)
            elif color.get(nxt) == 1:
                cycle = stack[stack.index(nxt):] + [nxt]
                ident = frozenset(cycle)
                if ident in reported:
                    continue
                reported.add(ident)
                path, line = state.edges[(node, nxt)]
                mod = next((m for m in modules.values() if m.path == path),
                           None)
                if mod is None:
                    continue
                anchor = ast.stmt()
                anchor.lineno, anchor.col_offset = line, 0
                state.findings.append((mod, mod.ctx.finding(
                    "static-lock-inversion", anchor,
                    "lock acquisition cycle " + " -> ".join(cycle)
                    + "; threads entering at different points deadlock")))
        stack.pop()
        color[node] = 2

    for node in sorted(adj):
        if color.get(node, 0) == 0:
            dfs(node)


def _check_then_act_findings(state: _ScanState) -> None:
    for key, tests in state.unlocked_tests.items():
        cls_id, _method = key
        cls = state.class_by_id.get(cls_id)
        if cls is None or not cls.lock_attrs:
            continue
        guarded = state.guarded_attrs.get(cls_id, set())
        writes = state.unlocked_writes.get(key, set())
        seen: set[str] = set()
        for attr, node in tests:
            if attr in seen or attr not in guarded or attr not in writes:
                continue
            seen.add(attr)
            state.findings.append((cls.module, cls.module.ctx.finding(
                "static-unlocked-check-then-act", node,
                f"self.{attr} is tested and written in "
                f"{cls.name}.{_method} with no lock held, but is "
                f"lock-guarded elsewhere in {cls.name}; hold the guarding "
                f"lock across the check and the write")))


def _finalize(state: _ScanState, modules: dict[str, _Module],
              enabled: Iterable[str] | None,
              disabled: Iterable[str]) -> list[Finding]:
    _cycle_findings(state, modules)
    _check_then_act_findings(state)
    allow = set(enabled) if enabled is not None else set(LOCK_RULES)
    allow -= set(disabled)
    out = [f for mod, f in state.findings
           if f.rule in allow and not mod.ctx.suppressed(f)]
    out.sort(key=finding_order)
    return out


def analyze_source(source: str, path: str = "<memory>", *,
                   enabled: Iterable[str] | None = None,
                   disabled: Iterable[str] = ()) -> list[Finding]:
    """Single-file mode (fixtures/tests): the file is its own program,
    so cross-file propagation sees only what it defines."""
    mod = _index_module(source, path)
    if mod is None:
        return []
    state, _ = _run([mod])
    return _finalize(state, {mod.modname: mod}, enabled, disabled)


def _collect(paths: Iterable[str],
             exclude: Iterable[str] = ()) -> tuple[_ScanState,
                                                   dict[str, _Module]]:
    modules: list[_Module] = []
    for path in iter_python_files(paths, exclude):
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        mod = _index_module(source, path)
        if mod is not None:
            modules.append(mod)
    state, _ = _run(modules)
    return state, {m.modname: m for m in modules}


def analyze_paths(paths: Iterable[str], *,
                  exclude: Iterable[str] = (),
                  enabled: Iterable[str] | None = None,
                  disabled: Iterable[str] = ()) -> list[Finding]:
    state, modules = _collect(paths, exclude)
    return _finalize(state, modules, enabled, disabled)


def static_edges(paths: Iterable[str] = (_PACKAGE,), *,
                 exclude: Iterable[str] = ()) -> list[tuple[str, str]]:
    """The proven acquisition edges, shaped exactly like the dynamic
    detector's ``acquisition_edges()`` so the two can be compared."""
    state, _ = _collect(paths, exclude)
    return sorted(state.edges)


def edge_sites(paths: Iterable[str] = (_PACKAGE,), *,
               exclude: Iterable[str] = ()) -> dict[tuple[str, str],
                                                    tuple[str, int]]:
    """Edges with the source site that proves each one (debugging aid)."""
    state, _ = _collect(paths, exclude)
    return dict(state.edges)
