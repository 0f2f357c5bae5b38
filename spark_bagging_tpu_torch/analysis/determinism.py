"""Determinism dataflow lint — nondeterminism sources must not reach
determinism sinks.

Every gate of the port — chaos/tenancy/online transcripts, fleet
merges, the digests its tests hold against the reference's — rests on
byte-determinism: same seed, same bytes, same decision (the
reproducibility-by-construction stance of *Reproducible Model
Selection Using Bagged Posteriors*). The failure
mode is always the same shape: a nondeterministic VALUE (a wall-clock
read, an unseeded RNG draw, an object identity, a set's iteration
order) flows into a determinism-critical SINK (a sha256/digest
construction, an event-log append, a ``snapshot()`` export, a sort
key) and the breach only surfaces weeks later as a flaky digest flip.
This engine is the static version of that post-mortem: an
intra-procedural AST taint pass from sources to sinks, run over the
whole port by the same CLI and tier-1 gate as the lint.

**Sources** (each its own rule, so suppressions stay precise):

- ``det-wallclock-sink`` — ``time.time/monotonic/perf_counter`` (and
  ``_ns`` variants), ``datetime.now/utcnow``. Sanctioned inside
  *clock-seam* functions: either the function takes an injectable
  ``now=`` parameter and the read only back-fills it (``now =
  time.time() if now is None else now`` — the admission/quarantine/
  alert-engine pattern), or the def carries an explicit
  ``# sbt-lint: clock-seam`` marker.
- ``det-unseeded-rng-sink`` — ``random.Random()`` with no seed, the
  module-level ``random.*`` draws (the process-global stream),
  ``os.urandom``, ``uuid.uuid4``/``uuid1``.
- ``det-identity-sink`` — ``id(x)`` and builtin ``hash(x)`` (both vary
  per process: CPython addresses and PYTHONHASHSEED). Also fires on
  ``sorted(..., key=id)`` / ``key=lambda x: hash(x)`` sort keys
  directly — an identity ORDER is as nondeterministic as an identity
  value.
- ``det-unordered-sink`` — iteration order of sets
  (``set()``/``frozenset()``/literals/comprehensions) and directory
  scans (``os.listdir``/``os.scandir``/``glob.glob``/``iterdir``).
  ``sorted(...)`` launders the taint — that IS the sanctioned fix.

**Sinks** (where tainted values are flagged):

- digest construction — ``hashlib.*`` constructors, ``.update()`` on a
  hash object, any call whose name contains ``digest``;
- event-log appends — ``telemetry.emit_event``/``_emit`` payloads.
  Timestamp-named keys (``t``, ``ts``, ``*_s``, ``*_ms``, ``*_at``,
  ``age``/``uptime``…) are sanctioned for WALL-CLOCK taint only: event
  timestamps are the one legitimate wall-clock-in-transcript use, and
  every digest over transcripts hashes a deterministic projection that
  strips them. A wall-clock read smuggled under
  a payload key — or any RNG/identity/unordered taint under ANY key —
  still fires;
- snapshot exports — ``return`` values of functions named
  ``snapshot``/``snapshot_*``/``to_dict`` (same timestamp-key
  sanction);
- sort keys — ``sorted(xs, key=...)``/``.sort(key=...)`` whose key
  computes ``id()``/``hash()``;
- inside a ``for`` loop over an unordered iterable, ANY sink call is
  order-tainted (``for x in some_set: h.update(x)`` — each element may
  be deterministic; the sequence is not).

The engine shares the lint's suppression grammar
(``# sbt-lint: disable=det-wallclock-sink — reason``) and file walk;
it registers no rules with the lint registry so ``--engines`` can run
either engine alone. Pure stdlib, no torch import.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Iterable, Iterator

from spark_bagging_tpu_torch.analysis.lint import (
    Finding,
    LintContext,
    _parse_markers,
    _parse_suppressions,
    dotted_name,
    finding_order,
    iter_python_files,
    module_nodes,
    parse,
)

__all__ = [
    "DET_RULES",
    "analyze_source",
    "analyze_file",
    "analyze_paths",
]

#: rule name -> one-line doc (the --list-rules table and the fixture
#: completeness gate in tests read this)
DET_RULES: dict[str, str] = {
    "det-wallclock-sink":
        "wall-clock read flows into a digest/transcript/snapshot sink "
        "outside a clock-seam function",
    "det-unseeded-rng-sink":
        "unseeded RNG value (random.Random(), module-level random.*, "
        "os.urandom, uuid4) flows into a determinism sink",
    "det-identity-sink":
        "id()/object-hash() value flows into a determinism sink or "
        "sort key",
    "det-unordered-sink":
        "set/directory-scan iteration order flows into a determinism "
        "sink (sorted(...) is the fix)",
}

# -- source model ------------------------------------------------------

_WALLCLOCK_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.clock_gettime",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
# the process-global random stream: any module-level draw
_GLOBAL_RNG_CALLS = {
    "random.random", "random.randint", "random.randrange",
    "random.choice", "random.choices", "random.sample",
    "random.shuffle", "random.uniform", "random.gauss",
    "random.getrandbits", "os.urandom", "uuid.uuid4", "uuid.uuid1",
    "uuid4", "uuid1",
}
_IDENTITY_CALLS = {"id", "hash"}
_UNORDERED_CALLS = {
    "set", "frozenset", "os.listdir", "os.scandir", "glob.glob",
    "glob.iglob",
}
# calls that return a deterministic value regardless of argument
# ORDER taint (sorted() is THE sanctioned fix; len/min/max are
# order-insensitive)
_UNORDERED_LAUNDER = {"sorted", "len", "min", "max"}

# -- sink model --------------------------------------------------------

_HASH_CONSTRUCTORS = {
    "hashlib.sha256", "hashlib.sha1", "hashlib.sha512", "hashlib.md5",
    "hashlib.blake2b", "hashlib.blake2s", "hashlib.new",
    "sha256", "sha1", "sha512", "md5", "blake2b",
}
_EVENT_SINKS = {"emit_event", "_emit"}
_SNAPSHOT_NAMES = re.compile(r"^(snapshot(_\w+)?|to_dict)$")
#: event/snapshot dict keys sanctioned to carry WALL-CLOCK values —
#: timestamps are the one legitimate wall-clock in a transcript (the
#: digest machinery hashes deterministic projections that strip them)
_TIMESTAMP_KEY = re.compile(
    r"(^|_)(t|ts|at|now|time|s|ms|ns|seconds|age|uptime|deadline|"
    r"eval|fired|resolved|hit|seen|scrape|start|end|since|created|"
    r"updated)(_|$)"
)

_KIND_LABEL = {
    "wallclock": ("det-wallclock-sink", "wall-clock read"),
    "rng": ("det-unseeded-rng-sink", "unseeded RNG value"),
    "identity": ("det-identity-sink", "id()/hash() identity value"),
    "unordered": ("det-unordered-sink", "unordered iteration"),
}


def _source_kind(call: ast.Call) -> str | None:
    """The taint kind a bare call expression introduces, if any."""
    name = dotted_name(call.func)
    if name is None:
        return None
    if name in _WALLCLOCK_CALLS:
        return "wallclock"
    if name in _GLOBAL_RNG_CALLS:
        return "rng"
    if name in _IDENTITY_CALLS and call.args:
        return "identity"
    if name in _UNORDERED_CALLS:
        return "unordered"
    # random.Random() / random.SystemRandom() with no seed argument:
    # the unseeded-constructor pattern (random.Random(seed) is fine)
    if name in ("random.Random", "Random") and not call.args:
        return "rng"
    if name in ("random.SystemRandom", "SystemRandom"):
        return "rng"
    return None


class _Taint:
    """Per-scope taint environment: name -> (kind, description)."""

    def __init__(self) -> None:
        self.names: dict[str, tuple[str, str]] = {}

    def copy(self) -> "_Taint":
        t = _Taint()
        t.names = dict(self.names)
        return t

    def merge(self, other: "_Taint") -> None:
        # branch join: union — a value tainted on EITHER path is tainted
        self.names.update(other.names)


class _FunctionPass:
    """One function (or module) body: order-aware taint walk."""

    def __init__(self, ctx: LintContext, fn: ast.AST,
                 enabled: set[str]) -> None:
        self.ctx = ctx
        self.fn = fn
        self.enabled = enabled
        self.findings: list[Finding] = []
        self.hash_objects: set[str] = set()
        # is this def a sanctioned clock seam?
        self.clock_seam = False
        self.now_param = False
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if ctx.marked(fn, "clock-seam"):
                self.clock_seam = True
            params = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
            self.now_param = "now" in params

    # -- taint evaluation ---------------------------------------------

    def taint_of(self, node: ast.AST, env: _Taint) -> tuple[str, str] | None:
        """(kind, what) if the expression's VALUE is nondeterministic."""
        if isinstance(node, ast.Name):
            return env.names.get(node.id)
        if isinstance(node, ast.Call):
            kind = self._call_source_kind(node)
            if kind is not None:
                return kind, ast.unparse(node.func) + "(...)"
            name = dotted_name(node.func)
            last = name.rsplit(".", 1)[-1] if name else ""
            arg_taints = [
                t for a in list(node.args)
                + [k.value for k in node.keywords]
                if (t := self.taint_of(a, env)) is not None
            ]
            if name in _UNORDERED_LAUNDER or last == "sorted":
                # sorted()/len()/min()/max() are order-insensitive:
                # unordered taint dies here, value taints survive
                arg_taints = [t for t in arg_taints
                              if t[0] != "unordered"]
            # a method call on a tainted receiver stays tainted
            # (", ".join(unordered_set), tainted.hex(), ...)
            if isinstance(node.func, ast.Attribute):
                t = self.taint_of(node.func.value, env)
                if t is not None:
                    arg_taints.append(t)
            return arg_taints[0] if arg_taints else None
        if isinstance(node, (ast.Set,)):
            return "unordered", "set literal"
        if isinstance(node, ast.SetComp):
            return "unordered", "set comprehension"
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            for gen in node.generators:
                t = self.taint_of(gen.iter, env)
                if t is not None and t[0] == "unordered":
                    return "unordered", f"comprehension over {t[1]}"
            t = self.taint_of(node.elt, env)
            return t
        if isinstance(node, ast.DictComp):
            for gen in node.generators:
                t = self.taint_of(gen.iter, env)
                if t is not None and t[0] == "unordered":
                    return "unordered", f"comprehension over {t[1]}"
            return None
        if isinstance(node, (ast.BinOp,)):
            return (self.taint_of(node.left, env)
                    or self.taint_of(node.right, env))
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                t = self.taint_of(v, env)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.UnaryOp):
            return self.taint_of(node.operand, env)
        if isinstance(node, ast.IfExp):
            return (self.taint_of(node.body, env)
                    or self.taint_of(node.orelse, env))
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                t = self.taint_of(v, env)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.FormattedValue):
            return self.taint_of(node.value, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            for el in node.elts:
                t = self.taint_of(el, env)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.Dict):
            for k in list(node.keys) + list(node.values):
                if k is None:
                    continue
                t = self.taint_of(k, env)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.Attribute):
            return self.taint_of(node.value, env)
        if isinstance(node, ast.Subscript):
            return self.taint_of(node.value, env)
        if isinstance(node, ast.Starred):
            return self.taint_of(node.value, env)
        if isinstance(node, ast.Await):
            return self.taint_of(node.value, env)
        return None

    def _call_source_kind(self, call: ast.Call) -> str | None:
        kind = _source_kind(call)
        if kind == "wallclock" and self.clock_seam:
            return None
        return kind

    # -- sink handling -------------------------------------------------

    def _emit(self, rule: str, node: ast.AST, what: str,
              sink: str) -> None:
        if rule not in self.enabled:
            return
        label = _KIND_LABEL[
            {v[0]: k for k, v in _KIND_LABEL.items()}[rule]][1]
        f = self.ctx.finding(
            rule, node,
            f"{label} ({what}) flows into {sink} — a nondeterministic "
            "input to a byte-determinism surface; thread a seed/"
            "injectable clock through, sort the iterable, or justify "
            f"with `# sbt-lint: disable={rule}`",
        )
        if not self.ctx.suppressed(f):
            self.findings.append(f)

    def _flag(self, taint: tuple[str, str], node: ast.AST,
              sink: str) -> None:
        self._emit(_KIND_LABEL[taint[0]][0], node, taint[1], sink)

    def _check_dict_payload(self, d: ast.Dict, env: _Taint,
                            sink: str) -> None:
        """Dict payloads headed for an event log / snapshot export:
        timestamp-named keys sanction WALL-CLOCK taint only."""
        for key, value in zip(d.keys, d.values):
            t = self.taint_of(value, env)
            if t is None:
                continue
            key_name = (key.value if isinstance(key, ast.Constant)
                        and isinstance(key.value, str) else None)
            if (t[0] == "wallclock" and key_name is not None
                    and _TIMESTAMP_KEY.search(key_name)):
                continue  # a timestamp field carrying a timestamp
            self._flag(t, value, f"{sink} (key {key_name!r})")

    def _check_sink_call(self, call: ast.Call, env: _Taint,
                         loop_unordered: str | None) -> None:
        name = dotted_name(call.func) or ""
        last = name.rsplit(".", 1)[-1]

        is_digest = (name in _HASH_CONSTRUCTORS
                     or "digest" in last.lower())
        is_update = (
            last == "update"
            and isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id in self.hash_objects
        )
        is_event = last in _EVENT_SINKS

        if is_digest or is_update:
            sink = f"digest construction `{name or last}(...)`"
            for a in list(call.args) + [k.value for k in call.keywords]:
                t = self.taint_of(a, env)
                if t is not None:
                    self._flag(t, a, sink)
            if loop_unordered is not None:
                self._emit("det-unordered-sink", call, loop_unordered,
                           sink + " inside an unordered loop")
        elif is_event:
            sink = f"event-log append `{last}(...)`"
            for a in call.args:
                if isinstance(a, ast.Dict):
                    self._check_dict_payload(a, env, sink)
                else:
                    t = self.taint_of(a, env)
                    if t is not None and t[0] != "wallclock":
                        self._flag(t, a, sink)
            if loop_unordered is not None:
                self._emit("det-unordered-sink", call, loop_unordered,
                           sink + " inside an unordered loop")

        # sort keys computing identities: sorted(xs, key=id) or
        # .sort(key=lambda x: hash(x))
        if last in ("sorted", "sort"):
            for kw in call.keywords:
                if kw.arg != "key":
                    continue
                k = kw.value
                key_ids = set()
                if isinstance(k, ast.Name):
                    key_ids.add(k.id)
                elif isinstance(k, ast.Lambda):
                    for sub in ast.walk(k.body):
                        if isinstance(sub, ast.Call):
                            n = dotted_name(sub.func)
                            if n in _IDENTITY_CALLS:
                                key_ids.add(n)
                if key_ids & _IDENTITY_CALLS:
                    self._emit(
                        "det-identity-sink", k,
                        f"sort key computing {sorted(key_ids & _IDENTITY_CALLS)[0]}()",
                        "a sort ORDER (varies per process)",
                    )

    # -- statement walk ------------------------------------------------

    def run(self) -> list[Finding]:
        body = getattr(self.fn, "body", [])
        self._walk(body, _Taint(), loop_unordered=None)
        return self.findings

    def _walk(self, body: list[ast.stmt], env: _Taint,
              loop_unordered: str | None) -> None:
        for stmt in body:
            self._stmt(stmt, env, loop_unordered)

    def _scan_calls(self, node: ast.AST, env: _Taint,
                    loop_unordered: str | None) -> None:
        """Visit every call in an expression tree (without entering
        nested defs) and apply sink checks."""
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if isinstance(sub, ast.Call):
                self._check_sink_call(sub, env, loop_unordered)

    def _assign_names(self, target: ast.expr) -> Iterator[str]:
        if isinstance(target, ast.Name):
            yield target.id
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                yield from self._assign_names(el)

    def _stmt(self, stmt: ast.stmt, env: _Taint,
              loop_unordered: str | None) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs get their own pass
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is None:
                return
            self._scan_calls(value, env, loop_unordered)
            taint = self.taint_of(value, env)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            names = [n for t in targets for n in self._assign_names(t)]
            # h = hashlib.sha256() binds a hash OBJECT: .update() on it
            # is a digest sink from here on
            if (isinstance(value, ast.Call)
                    and dotted_name(value.func) in _HASH_CONSTRUCTORS):
                self.hash_objects.update(names)
                taint = None
            # `now = time.time()` inside a function with an injectable
            # now= parameter: the sanctioned default-fill — not taint
            if (taint is not None and taint[0] == "wallclock"
                    and self.now_param and names == ["now"]):
                taint = None
            for n in names:
                if taint is not None:
                    env.names[n] = taint
                elif not isinstance(stmt, ast.AugAssign):
                    env.names.pop(n, None)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._scan_calls(stmt.value, env, loop_unordered)
                self._check_return(stmt, env)
            return
        if isinstance(stmt, ast.Expr):
            self._scan_calls(stmt.value, env, loop_unordered)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_calls(stmt.iter, env, loop_unordered)
            iter_taint = self.taint_of(stmt.iter, env)
            inner_unordered = loop_unordered
            if iter_taint is not None and iter_taint[0] == "unordered":
                inner_unordered = iter_taint[1]
            branch = env.copy()
            # a loop var drawn from a tainted iterable carries its
            # VALUE taint (rng/identity); order taint is handled by
            # inner_unordered at the sink
            if iter_taint is not None and iter_taint[0] != "unordered":
                for n in self._assign_names(stmt.target):
                    branch.names[n] = iter_taint
            self._walk(stmt.body, branch, inner_unordered)
            self._walk(stmt.orelse, branch, loop_unordered)
            env.merge(branch)
            return
        if isinstance(stmt, ast.While):
            self._scan_calls(stmt.test, env, loop_unordered)
            branch = env.copy()
            self._walk(stmt.body, branch, loop_unordered)
            self._walk(stmt.orelse, branch, loop_unordered)
            env.merge(branch)
            return
        if isinstance(stmt, ast.If):
            self._scan_calls(stmt.test, env, loop_unordered)
            b1, b2 = env.copy(), env.copy()
            self._walk(stmt.body, b1, loop_unordered)
            self._walk(stmt.orelse, b2, loop_unordered)
            env.merge(b1)
            env.merge(b2)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_calls(item.context_expr, env, loop_unordered)
            self._walk(stmt.body, env, loop_unordered)
            return
        if isinstance(stmt, ast.Try):
            branch = env.copy()
            self._walk(stmt.body, branch, loop_unordered)
            for h in stmt.handlers:
                hb = env.copy()
                self._walk(h.body, hb, loop_unordered)
                branch.merge(hb)
            self._walk(stmt.orelse, branch, loop_unordered)
            self._walk(stmt.finalbody, branch, loop_unordered)
            env.merge(branch)
            return
        if isinstance(stmt, (ast.Raise, ast.Assert)):
            for sub in ast.iter_child_nodes(stmt):
                self._scan_calls(sub, env, loop_unordered)
            return
        # Delete/Pass/Import/Global/...: nothing flows

    def _check_return(self, stmt: ast.Return, env: _Taint) -> None:
        """snapshot()/to_dict() exports: a tainted return value is a
        nondeterministic byte in an artifact consumers digest/diff."""
        fn = self.fn
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if not _SNAPSHOT_NAMES.match(fn.name):
            return
        sink = f"snapshot export `{fn.name}()` return"
        value = stmt.value
        if isinstance(value, ast.Dict):
            self._check_dict_payload(value, env, sink)
            return
        t = self.taint_of(value, env)
        if t is not None and t[0] != "wallclock":
            self._flag(t, value, sink)


# -- running -----------------------------------------------------------


def analyze_source(
    source: str,
    path: str = "<string>",
    *,
    enabled: Iterable[str] | None = None,
    disabled: Iterable[str] = (),
) -> list[Finding]:
    """Run the determinism dataflow pass over one source string.
    Mirrors :func:`~spark_bagging_tpu_torch.analysis.lint.lint_source`:
    ``enabled=None`` runs every rule minus ``disabled``."""
    names = set(DET_RULES) if enabled is None else set(enabled)
    unknown = names - set(DET_RULES)
    if unknown:
        raise KeyError(
            f"unknown determinism rule(s) {sorted(unknown)}; "
            f"known: {sorted(DET_RULES)}"
        )
    names -= set(disabled)
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
    findings: list[Finding] = []
    scopes: list[ast.AST] = [tree]
    scopes += [n for n in module_nodes(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        findings.extend(_FunctionPass(ctx, scope, names).run())
    return sorted(set(findings), key=finding_order)


def analyze_file(path: str, **kw: Any) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        return analyze_source(fh.read(), path, **kw)


def analyze_paths(
    paths: Iterable[str],
    *,
    exclude: Iterable[str] = (),
    disabled: Iterable[str] = (),
) -> list[Finding]:
    findings: list[Finding] = []
    for fp in iter_python_files(paths, exclude):
        findings.extend(analyze_file(fp, disabled=disabled))
    return findings
