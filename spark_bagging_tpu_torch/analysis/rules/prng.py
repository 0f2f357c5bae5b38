"""PRNG hygiene over the port's explicit keys (``ops/prng.py``).

Bagging's statistical guarantees assume independent bootstrap draws;
the whole RNG design of the port (threefry keys as ``(..., 2)`` int64
tensors, stream-tagged ``prng.fold_in`` keys, ``prng.split`` before
every consumption — ops/bootstrap.py) exists so that no two draws ever
share a key. Key REUSE produces correlated replicas — an ensemble that
silently stops averaging out variance, undetectable by any unit test
that checks shapes and losses. Time-seeded keys kill reproducibility
and (worse) collide across workers launched in the same tick.

Keys are made by ``prng.key``, derived by ``prng.split`` /
``prng.fold_in`` (and ops/bootstrap's ``fit_key``, ``online_step_key``,
``split_init_fit``, ``replica_init_fit_keys``), and consumed by the
``prng`` samplers (``uniform``, ``normal``, ``random_bits``,
``permutation``, ``randint``, ``poisson``) and ops/bootstrap's draws.
The samplers and ``poisson_counts`` read the key's own bits, so any two
of them on one key draw the same stream; ``bootstrap_weights`` and
``feature_subspaces`` each fold a stream tag of their own into the key
first, so each collides only with itself.

The reuse rule is branch-aware: two samplers consuming one key in
mutually-exclusive ``if`` arms execute at most once per call and are
fine; two samplers in the same straight-line block, or one sampler in a
loop whose key was derived outside it, are real reuse.
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

# deriving new keys from one is the sanctioned way to use it twice
_KEY_DERIVERS = {"split", "fold_in", "fit_key", "online_step_key",
                 "split_init_fit", "replica_init_fit_keys"}
# prng.<sampler>(key, ...) reads the key's own bits
_SAMPLERS = {"uniform", "normal", "random_bits", "permutation", "randint",
             "poisson"}
# ops/bootstrap's draws -> the stream their bits come from
_BOOTSTRAP_DRAWS = {"poisson_counts": "raw", "bootstrap_weights": "rows",
                    "feature_subspaces": "features"}

_TIME_SOURCES = {
    "time.time", "time.time_ns", "time.monotonic", "time.perf_counter",
    "datetime.now", "datetime.datetime.now", "os.urandom",
    "random.randint", "random.random", "np.random.randint",
    "numpy.random.randint",
}

def _is_key_maker(name: str | None) -> bool:
    return bool(name) and name.split(".")[-2:] == ["prng", "key"]


def _consumer_stream(call: ast.Call) -> str | None:
    """The stream a key-consuming call draws from, or None when the
    call consumes no key."""
    name = dotted_name(call.func)
    if not name:
        return None
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "prng" and parts[-1] in _SAMPLERS:
        return "raw"
    if parts[-1] in _BOOTSTRAP_DRAWS and (len(parts) == 1
                                          or parts[-2] == "bootstrap"):
        return _BOOTSTRAP_DRAWS[parts[-1]]
    return None


def _key_sources(fn: ast.AST) -> set[str]:
    """Names in this scope that plausibly hold PRNG keys: assigned from
    prng.key or a deriver, or parameters literally named ``key``/
    ``rng``/``k``/``*_key``."""
    names: set[str] = set()
    if isinstance(fn, ast.FunctionDef):
        for a in [*fn.args.args, *fn.args.kwonlyargs]:
            if a.arg in ("key", "rng", "k") or a.arg.endswith("_key"):
                names.add(a.arg)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        if not isinstance(v, ast.Call):
            continue
        src = dotted_name(v.func) or ""
        leaf = src.split(".")[-1]
        if _is_key_maker(src) or leaf in _KEY_DERIVERS:
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
    return names


def _expr_parts(stmt: ast.stmt) -> list[ast.AST]:
    """Nodes belonging to THIS statement (header expressions for
    compound statements), not entering child blocks or nested scopes."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots: list[ast.AST] = [stmt.iter]
    elif isinstance(stmt, ast.While):
        roots = [stmt.test]
    elif isinstance(stmt, ast.If):
        roots = [stmt.test]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = [i.context_expr for i in stmt.items]
    elif isinstance(stmt, ast.Try):
        roots = []
    else:
        roots = [stmt]
    out: list[ast.AST] = []
    for r in roots:
        out.append(r)
        out.extend(walk_skip_defs(r))
    return out


def _consumers_in(nodes: list[ast.AST], keys: set[str]) -> Iterator[
    tuple[tuple[str, str], ast.Call]
]:
    for n in nodes:
        if (
            isinstance(n, ast.Call)
            and n.args
            and isinstance(n.args[0], ast.Name)
            and n.args[0].id in keys
        ):
            stream = _consumer_stream(n)
            if stream is not None:
                yield (n.args[0].id, stream), n


def _rederived_names(nodes: list[ast.AST]) -> set[str]:
    """Names assigned in these nodes from split/fold_in — deriving a
    fresh key inside a loop is the sanctioned per-iteration pattern."""
    out: set[str] = set()
    for n in nodes:
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            leaf = (dotted_name(n.value.func) or "").split(".")[-1]
            if leaf in _KEY_DERIVERS or leaf == "key":
                for t in n.targets:
                    out |= {
                        x.id for x in ast.walk(t) if isinstance(x, ast.Name)
                    }
    return out


@rule("prng-key-reuse")
def prng_key_reuse(ctx: LintContext) -> Iterator[Finding]:
    """One PRNG key consumed by two samplers on the same path (or by a
    sampler in a loop, key derived outside) — identical draws, not
    independent ones."""
    if "prng." not in ctx.source and not any(
            d in ctx.source for d in _BOOTSTRAP_DRAWS):
        return  # no key consumer can be named in this file
    scopes = [
        n for n in ctx.nodes() if isinstance(n, ast.FunctionDef)
    ] or [ctx.tree]
    for fn in scopes:
        keys = _key_sources(fn)
        if not keys:
            continue
        yield from _check_block(ctx, getattr(fn, "body", []), keys,
                                seen={}, in_loop=frozenset())


def _check_block(
    ctx: LintContext,
    body: list[ast.stmt],
    keys: set[str],
    *,
    seen: dict[tuple[str, str], ast.Call],
    in_loop: frozenset[str],
) -> Iterator[Finding]:
    """Walk one statement list. ``seen`` carries the first consumer per
    (key, stream) on the current path (``if`` arms get isolated copies,
    so mutually-exclusive consumption never conflicts); ``in_loop``
    names keys derived OUTSIDE a loop we are now inside — a single
    consumption there already repeats per iteration."""
    for stmt in body:
        parts = _expr_parts(stmt)
        for (k, stream), call in _consumers_in(parts, keys):
            if k in in_loop:
                yield ctx.finding(
                    "prng-key-reuse", call,
                    f"key `{k}` consumed inside a loop but derived "
                    "outside it: every iteration repeats the SAME "
                    "draw; fold_in the loop index first",
                )
                continue
            first = seen.get((k, stream))
            if first is None:
                seen[(k, stream)] = call
            else:
                yield ctx.finding(
                    "prng-key-reuse", call,
                    f"key `{k}` already consumed by a sampler on line "
                    f"{first.lineno}; reusing it repeats the SAME draw "
                    "— split/fold_in first",
                )
        # a re-derivation on this path resets the key's budget
        rederived_here = _rederived_names(parts)
        for entry in [e for e in seen if e[0] in rederived_here]:
            seen.pop(entry)
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            # keys not re-derived per iteration become loop-tainted
            loop_parts = [p for s in stmt.body for p in _expr_parts(s)]
            rederived = _rederived_names(loop_parts)
            taint = in_loop | frozenset(keys - rederived)
            yield from _check_block(ctx, stmt.body, keys,
                                    seen=dict(seen), in_loop=taint)
            yield from _check_block(ctx, stmt.orelse, keys,
                                    seen=dict(seen), in_loop=in_loop)
        elif isinstance(stmt, ast.If):
            # arms are mutually exclusive: each starts from this
            # block's seen-state but cannot conflict with the other
            for arm in (stmt.body, stmt.orelse):
                yield from _check_block(ctx, arm, keys,
                                        seen=dict(seen), in_loop=in_loop)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield from _check_block(ctx, stmt.body, keys,
                                    seen=seen, in_loop=in_loop)
        elif isinstance(stmt, ast.Try):
            for blk in (stmt.body, stmt.orelse, stmt.finalbody,
                        *[h.body for h in stmt.handlers]):
                yield from _check_block(ctx, blk, keys,
                                        seen=dict(seen), in_loop=in_loop)


@rule("prng-nondeterministic-seed")
def prng_nondeterministic_seed(ctx: LintContext) -> Iterator[Finding]:
    """``prng.key`` seeded from wall clock / os randomness — kills
    reproducibility and collides across same-tick workers."""
    for node in ctx.nodes():
        if not isinstance(node, ast.Call):
            continue
        if not _is_key_maker(dotted_name(node.func)):
            continue
        for arg in node.args:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call):
                    src = dotted_name(sub.func)
                    if src in _TIME_SOURCES:
                        yield ctx.finding(
                            "prng-nondeterministic-seed", node,
                            f"prng.key seeded from `{src}()`: fits stop "
                            "being reproducible, and workers started "
                            "in the same tick draw IDENTICAL "
                            "bootstraps; thread a seed in explicitly",
                        )
