"""CLI: ``python -m spark_bagging_tpu_torch.analysis [paths...]``.

Exit status is the contract — 0 for a clean tree, 1 when findings
remain, 2 for usage errors — so the command drops straight into CI.
With no paths it analyzes the port's defaults (the package and
``chip_smoke.py``), or what a ``[tool.sbt-lint-torch] paths`` table in
pyproject.toml names.

Four engines, selected with ``--engines`` (default: all, or the
``engines`` list of the config):

* ``lint`` — the port's correctness rules over the given paths;
* ``determinism`` — the nondeterminism source→sink dataflow pass;
* ``contracts`` — whole-repo cross-artifact checks (always anchored at
  the repo root, not the path arguments: its artifacts — SERIES_HELP,
  faults.SITES, the route and verdict tables in README.md — live at
  fixed locations);
* ``locks`` — the static make_lock acquisition-graph analysis.

``--format json`` emits one schema-stable object with per-engine
finding counts, the reference package's payload, so CI can diff
analyzer runs.
"""

from __future__ import annotations

import argparse
import json
import sys

from spark_bagging_tpu_torch.analysis import (
    contracts,
    determinism,
    locks_static,
)
from spark_bagging_tpu_torch.analysis.lint import (
    RULES,
    Finding,
    _load_rules,
    lint_paths,
    load_config,
    render_text,
)

#: Canonical engine order — also the JSON key order.
ENGINES = ("lint", "determinism", "contracts", "locks")

#: Version of the ``--format json`` payload; bump only with a
#: deliberate, test-acknowledged schema change.
JSON_SCHEMA_VERSION = 1


def _rule_universe() -> dict[str, set[str]]:
    _load_rules()
    return {
        "lint": set(RULES),
        "determinism": set(determinism.DET_RULES),
        "contracts": set(contracts.CONTRACT_CHECKS),
        "locks": set(locks_static.LOCK_RULES),
    }


def run_engines(engines: list[str], paths: list[str],
                exclude: list[str],
                disabled: set[str]) -> dict[str, list[Finding]]:
    """Run each selected engine; disabled names are routed to whichever
    engine owns them (names are globally unique across engines)."""
    universe = _rule_universe()
    out: dict[str, list[Finding]] = {}
    for name in engines:
        own_disabled = disabled & universe[name]
        if name == "lint":
            out[name] = lint_paths(paths, exclude=exclude,
                                   disabled=own_disabled)
        elif name == "determinism":
            out[name] = determinism.analyze_paths(
                paths, exclude=exclude, disabled=own_disabled)
        elif name == "contracts":
            out[name] = contracts.check_repo(".", disabled=own_disabled)
        elif name == "locks":
            out[name] = locks_static.analyze_paths(
                paths, exclude=exclude, disabled=own_disabled)
    return out


def render_unified_json(per_engine: dict[str, list[Finding]]) -> str:
    findings = [
        {"engine": engine, "rule": f.rule, "path": f.path,
         "line": f.line, "col": f.col, "message": f.message}
        for engine in per_engine
        for f in per_engine[engine]
    ]
    payload = {
        "schema": JSON_SCHEMA_VERSION,
        "clean": not findings,
        "engines": {engine: {"findings": len(per_engine[engine])}
                    for engine in per_engine},
        "findings": findings,
    }
    return json.dumps(payload, indent=2) + "\n"


def render_unified_text(per_engine: dict[str, list[Finding]]) -> str:
    flat = [f for fs in per_engine.values() for f in fs]
    counts = ", ".join(f"{engine}: {len(per_engine[engine])}"
                       for engine in per_engine)
    if not flat:
        return f"sbt-lint: clean ({counts})\n"
    body = "\n".join(f.render() for f in flat)
    return f"{body}\nsbt-lint: {len(flat)} finding(s) ({counts})\n"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spark_bagging_tpu_torch.analysis",
        description="static analysis of the torch port (sbt-lint)",
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to analyze (default: the port and "
                        "chip_smoke.py, or [tool.sbt-lint-torch] paths)")
    p.add_argument("--engines", default=None, metavar="NAMES",
                   help="comma-separated engine list out of "
                        f"{','.join(ENGINES)} (default: config or all)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--disable", action="append", default=[],
                   metavar="RULE", help="disable a rule/check (repeatable)")
    p.add_argument("--no-config", action="store_true",
                   help="ignore pyproject.toml [tool.sbt-lint-torch]")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table of every engine and exit")
    args = p.parse_args(argv)

    universe = _rule_universe()
    if args.list_rules:
        docs: dict[str, dict[str, str]] = {
            "lint": {n: RULES[n].doc for n in RULES},
            "determinism": dict(determinism.DET_RULES),
            "contracts": {n: doc for n, (doc, _fn)
                          in contracts.CONTRACT_CHECKS.items()},
            "locks": dict(locks_static.LOCK_RULES),
        }
        width = max(len(n) for table in docs.values() for n in table)
        for engine in ENGINES:
            print(f"[{engine}]")
            for name in sorted(docs[engine]):
                print(f"  {name:<{width}}  {docs[engine][name]}")
        return 0

    cfg = (
        {"paths": [], "exclude": [], "disable": [], "engines": []}
        if args.no_config else load_config()
    )
    paths = args.paths or cfg["paths"]
    if not paths:
        p.error("no paths given and none configured")

    raw = args.engines if args.engines is not None \
        else ",".join(cfg.get("engines") or ENGINES)
    engines = [e.strip() for e in raw.split(",") if e.strip()]
    unknown_engines = [e for e in engines if e not in ENGINES]
    if unknown_engines:
        p.error(f"unknown engine(s) {unknown_engines}; "
                f"known: {list(ENGINES)}")
    engines = [e for e in ENGINES if e in engines]  # canonical order

    disabled = set(cfg["disable"]) | set(args.disable)
    known = set().union(*universe.values())
    unknown = disabled - known
    if unknown:
        p.error(f"unknown rule(s) in disable: {sorted(unknown)}")

    try:
        per_engine = run_engines(engines, paths, cfg["exclude"], disabled)
    except FileNotFoundError as e:
        p.error(str(e))
    if args.format == "json":
        out = render_unified_json(per_engine)
    elif engines == ["lint"]:
        # Single classic engine: keep the lint's own text format.
        out = render_text(per_engine["lint"])
    else:
        out = render_unified_text(per_engine)
    sys.stdout.write(out)
    return 1 if any(per_engine.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
