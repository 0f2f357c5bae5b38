"""The port's lint engine and CLI, held against the JAX package's:

- every rule that carries over (``host-sync-in-span``, ``hot-path-alloc``,
  ``swallowed-fault``, ``shared-state-unlocked``) gives the same findings
  — rule, line, column, message — as the JAX engine on the JAX package's
  BAD/GOOD fixture snippets (copied), bitwise; ``hot-path-alloc``'s
  urandom message names its history in other words, which the comparison
  strips;
- the torch twins (``host-sync-in-capture`` for ``host-sync-in-jit``;
  ``prng-key-reuse`` and ``prng-nondeterministic-seed`` over the port's
  explicit keys) have BAD/GOOD pairs of their own, and the PRNG twins
  keep the JAX rules' semantics line for line on the JAX snippets
  translated to ``prng.*``;
- every registered rule has fixtures; the dropped rules are absent;
- suppressions, the CLI's exit codes and JSON payload (the JAX CLI's),
  the port's configuration, the package surface (``__all__`` = JAX's)
  and the self-hosting gate: all four engines over the port's tree
  through the real CLI, zero findings, within 15 s.
"""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

pytest.importorskip("torch")

from spark_bagging_tpu_torch.analysis import lint_source, load_config  # noqa: E402
from spark_bagging_tpu_torch.analysis.__main__ import main as port_main  # noqa: E402
from spark_bagging_tpu_torch.analysis.lint import RULES, _load_rules  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ANALYSIS = os.path.join(REPO, "spark_bagging_tpu_torch", "analysis")


def hits(src: str, rule: str) -> list:
    return list(lint_source(src, enabled={rule}))


def jax_hits(src: str, rule: str) -> list:
    from spark_bagging_tpu.analysis import lint_source as jax_lint

    return list(jax_lint(src, enabled={rule}))


# the one reworded message: the JAX text names the regression that
# taught the rule, the port's the same thing without the reference
_REWORDED = re.compile(r" \([^)]*trace ids\)")


def as_tuples(findings) -> list[tuple]:
    """Findings as comparable tuples, sorted: the JAX engines order two
    findings at one position by set iteration, which varies by process."""
    return sorted((f.rule, f.line, f.col, _REWORDED.sub("", f.message))
                  for f in findings)


# -- the JAX package's fixtures of the rules that carry over (copied) ----

CARRIED = {
    "host-sync-in-span": (
        """
import numpy as np
from spark_bagging_tpu import telemetry

def serve(compiled, X):
    with telemetry.span("forward"):
        out = compiled(X)
        host = np.asarray(out)
    return host
""",
        """
import numpy as np
from spark_bagging_tpu import telemetry

def serve(compiled, X):
    with telemetry.span("forward"):
        out = compiled(X)
    return np.asarray(out)
""",
    ),
    "hot-path-alloc": (
        """
import os
import logging

log = logging.getLogger("serving")

# sbt-lint: hot-path
def submit(req):
    token = os.urandom(8).hex()
    attrs = {k: str(v) for k, v in req.items()}
    log.debug("request %s %s", token, attrs)
    return token
""",
        """
import itertools
import os

_ids = itertools.count()

# sbt-lint: hot-path
def submit(req):
    return next(_ids), req

def cold_path(req):
    # un-marked functions may allocate freely: the rule is opt-in
    return os.urandom(8).hex(), {k: str(v) for k, v in req.items()}
""",
    ),
    "swallowed-fault": (
        """
def serve_batch(executor, batch):
    try:
        return executor.forward(batch)
    except Exception:
        pass
""",
        """
from spark_bagging_tpu import telemetry

def serve_batch(executor, batch, future):
    try:
        return executor.forward(batch)
    except Exception as e:
        telemetry.inc("sbt_serving_batch_errors_total")
        future.set_exception(e)
    try:
        return executor.forward(batch)
    except OSError:
        return None  # narrow handlers are deliberate-by-construction
    try:
        return executor.forward(batch)
    except Exception:
        raise
""",
    ),
    "shared-state-unlocked": (
        """
import threading

# sbt-lint: shared-state
class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def add(self, k, v):
        self._items[k] = v
""",
        """
import threading

# sbt-lint: shared-state
class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = {}

    def add(self, k, v):
        with self._lock:
            self._items[k] = v
""",
    ),
}

# JAX's targeted behaviours of the carried rules (copied)
CARRIED_EXTRA = {
    "host-sync-in-span": """
from spark_bagging_tpu import telemetry

def report(X):
    with telemetry.span("aggregate"):
        n = int(X.shape[0])
    return n
""",
}

# -- the torch twins' own fixtures ----------------------------------------

TWINS = {
    "host-sync-in-capture": (
        """
import torch

def capture(graph, pool, fn, x, out):
    graph.capture_begin(pool=pool)
    try:
        out.copy_(fn(x))
        peak = out.max().item()
    finally:
        graph.capture_end()
    return peak
""",
        """
import torch

def capture(graph, pool, fn, x, out):
    graph.capture_begin(pool=pool)
    try:
        out.copy_(fn(x))
    finally:
        graph.capture_end()
    torch.cuda.synchronize()
    return out.max().item()
""",
    ),
    "prng-key-reuse": (
        """
from spark_bagging_tpu_torch.ops import prng

def init(key):
    w = prng.normal(key, (4,))
    b = prng.uniform(key, (4,))
    return w, b
""",
        """
from spark_bagging_tpu_torch.ops import prng

def init(key):
    kw, kb = prng.split(key)
    w = prng.normal(kw, (4,))
    b = prng.uniform(kb, (4,))
    return w, b
""",
    ),
    "prng-nondeterministic-seed": (
        """
import time
from spark_bagging_tpu_torch.ops import prng

def make_key():
    return prng.key(int(time.time()))
""",
        """
from spark_bagging_tpu_torch.ops import prng

def make_key(seed: int):
    return prng.key(seed)
""",
    ),
}

PORT_BAD_GOOD = {**CARRIED, **TWINS}

DROPPED = ("host-sync-in-jit", "jit-in-loop", "static-argnums-array",
           "loop-constant-capture", "tracer-escape", "donated-arg-reuse")


@pytest.mark.parametrize("rule", sorted(CARRIED))
@pytest.mark.parametrize("which", ["bad", "good"])
def test_carried_rule_matches_jax_on_its_fixture(rule, which):
    src = CARRIED[rule][0 if which == "bad" else 1]
    got = as_tuples(hits(src, rule))
    assert got == as_tuples(jax_hits(src, rule))
    assert bool(got) == (which == "bad")


@pytest.mark.parametrize("rule", sorted(CARRIED_EXTRA))
def test_carried_rule_matches_jax_on_its_targeted_case(rule):
    src = CARRIED_EXTRA[rule]
    assert as_tuples(hits(src, rule)) == as_tuples(jax_hits(src, rule))


@pytest.mark.parametrize("rule", sorted(PORT_BAD_GOOD))
def test_rule_fires_on_bad_fixture(rule):
    found = hits(PORT_BAD_GOOD[rule][0], rule)
    assert found, f"{rule} missed its known-bad fixture"
    assert all(f.rule == rule for f in found)


@pytest.mark.parametrize("rule", sorted(PORT_BAD_GOOD))
def test_rule_silent_on_good_twin(rule):
    found = hits(PORT_BAD_GOOD[rule][1], rule)
    assert not found, f"{rule} false-positived on its good twin: {found}"


def test_every_registered_rule_has_fixtures():
    _load_rules()
    assert set(RULES) == set(PORT_BAD_GOOD)
    assert not set(DROPPED) & set(RULES)


# -- the capture twin ---------------------------------------------------


def test_capture_rule_reads_torch_cuda_graph_bodies():
    src = """
import torch

def capture(g, fn, x):
    with torch.cuda.graph(g):
        y = fn(x)
        host = y.cpu()
    return host
"""
    found = hits(src, "host-sync-in-capture")
    assert [(f.line, f.message.split(" ")[0]) for f in found] == [
        (7, ".cpu()")]


def test_capture_rule_sees_only_between_begin_and_end():
    src = """
def capture(graph, fn, x, out):
    n = float(x.sum())
    graph.capture_begin()
    out.copy_(fn(x))
    graph.capture_end()
    return n, out.numpy()
"""
    assert not hits(src, "host-sync-in-capture")


def test_span_rule_knows_the_torch_syncs():
    src = """
import torch
from spark_bagging_tpu_torch import telemetry

def fit(step, X):
    with telemetry.span("fit"):
        out = step(X)
        torch.cuda.synchronize()
        host = out.cpu()
        arr = host.numpy()
    return arr
"""
    found = hits(src, "host-sync-in-span")
    assert [f.line for f in found] == [8, 9, 10]


# -- the PRNG twins keep JAX's semantics on translated snippets -----------

# JAX's prng fixtures and targeted cases (copied), run through the JAX
# rule as they are and through the port's rule with ``jax.random.*``
# spelled ``prng.*`` (one line for one line)
JAX_PRNG_SOURCES = {
    "bad": """
import jax

def init(key):
    w = jax.random.normal(key, (4,))
    b = jax.random.uniform(key, (4,))
    return w, b
""",
    "good": """
import jax

def init(key):
    kw, kb = jax.random.split(key)
    w = jax.random.normal(kw, (4,))
    b = jax.random.uniform(kb, (4,))
    return w, b
""",
    "branch_exclusive": """
import jax

def draw(key, replacement):
    k = jax.random.fold_in(key, 7)
    if replacement:
        return jax.random.poisson(k, 1.0, (8,))
    return jax.random.uniform(k, (8,))
""",
    "loop_reuse": """
import jax

def noise(key, n):
    outs = []
    for i in range(n):
        outs.append(jax.random.normal(key, (4,)))
    return outs
""",
    "loop_rederive": """
import jax

def noise(key, n):
    outs = []
    for i in range(n):
        k = jax.random.fold_in(key, i)
        outs.append(jax.random.normal(k, (4,)))
    return outs
""",
    "wrapped_suppression": """
import jax

def init(key):
    w = jax.random.normal(key, (4,))
    # sbt-lint: disable=prng-key-reuse — fixture
    b = jax.random.uniform(
        key,
        (4,),
    )
    return w, b
""",
    "seed": """
import time
import jax

def make_key():
    return jax.random.PRNGKey(int(time.time()))
""",
}


def _to_port(src: str) -> str:
    return (src.replace("import jax\n",
                        "from spark_bagging_tpu_torch.ops import prng\n")
            .replace("jax.random.PRNGKey(", "prng.key(")
            .replace("jax.random.", "prng."))


@pytest.mark.parametrize("case", sorted(JAX_PRNG_SOURCES))
def test_prng_twins_keep_jax_semantics(case):
    src = JAX_PRNG_SOURCES[case]
    rules = ("prng-key-reuse", "prng-nondeterministic-seed")

    def lines(fs):
        return [(f.rule, f.line) for f in fs]

    for rule in rules:
        assert lines(hits(_to_port(src), rule)) == lines(
            jax_hits(src, rule)), (case, rule)


def test_prng_bootstrap_draws_collide_only_within_their_stream():
    src = """
from spark_bagging_tpu_torch.ops import prng
from spark_bagging_tpu_torch.ops.bootstrap import (
    bootstrap_weights, feature_subspaces, poisson_counts,
)

def fit_draws(k, ids, n, F):
    w = bootstrap_weights(k, ids, n)
    s = feature_subspaces(k, ids, F, 4)
    return w, s

def twice(k, ids, n):
    return bootstrap_weights(k, ids, n), bootstrap_weights(k, ids, n)

def raw(k, n):
    u = prng.uniform(k, n)
    return u, poisson_counts(k, 1.0, n)
"""
    found = hits(src, "prng-key-reuse")
    assert [f.line for f in found] == [13, 17]


# -- suppressions --------------------------------------------------------

BAD_PRNG = TWINS["prng-key-reuse"][0]
_B_LINE = "b = prng.uniform(key, (4,))"


def test_same_line_suppression():
    src = BAD_PRNG.replace(
        _B_LINE, _B_LINE + "  # sbt-lint: disable=prng-key-reuse")
    assert not hits(src, "prng-key-reuse")


def test_comment_line_above_suppresses_next_line():
    src = BAD_PRNG.replace(
        "    " + _B_LINE,
        "    # sbt-lint: disable=prng-key-reuse — fixture\n    " + _B_LINE)
    assert not hits(src, "prng-key-reuse")


def test_disable_all_wildcard_and_rule_specificity():
    assert not lint_source(BAD_PRNG.replace(
        _B_LINE, _B_LINE + "  # sbt-lint: disable=all"))
    assert hits(BAD_PRNG.replace(
        _B_LINE, _B_LINE + "  # sbt-lint: disable=hot-path-alloc"),
        "prng-key-reuse")


def test_unknown_rule_and_syntax_error():
    with pytest.raises(KeyError):
        lint_source("x = 1\n", enabled={"jit-in-loop"})
    assert [f.rule for f in lint_source("def broken(:\n")] == [
        "syntax-error"]


# -- the CLI against JAX's -----------------------------------------------


def _jax_main(argv):
    from spark_bagging_tpu.analysis.__main__ import main

    return main(argv)


SHARED_BAD = CARRIED["shared-state-unlocked"][0]


@pytest.mark.parametrize("case", ["clean", "findings"])
def test_cli_exit_codes_and_json_match_jax(tmp_path, capsys, case):
    p = tmp_path / "f.py"
    p.write_text("x = 1\n" if case == "clean" else SHARED_BAD)
    argv = [str(p), "--no-config", "--format", "json",
            "--engines", "lint,determinism,locks"]
    rc_port = port_main(argv)
    port = json.loads(capsys.readouterr().out)
    rc_jax = _jax_main(argv)
    ref = json.loads(capsys.readouterr().out)
    assert rc_port == rc_jax == (0 if case == "clean" else 1)
    assert sorted(port) == sorted(ref) == ["clean", "engines", "findings",
                                           "schema"]
    assert port["schema"] == ref["schema"] == 1
    assert list(port["engines"]) == list(ref["engines"])
    assert port["engines"] == ref["engines"]
    assert sorted(map(json.dumps, port["findings"])) == sorted(
        map(json.dumps, ref["findings"]))


@pytest.mark.parametrize("argv", [
    ["definitely_not_a_path_xyz", "--no-config"],
    ["--no-config", "--engines", "lint,warp", "x.py"],
    ["--no-config", "--disable", "no-such-rule", "x.py"],
])
def test_cli_usage_errors_exit_two_as_jax(capsys, argv):
    for main in (port_main, _jax_main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
    capsys.readouterr()


def test_cli_text_format_and_disable(tmp_path, capsys):
    p = tmp_path / "bad.py"
    p.write_text(BAD_PRNG)
    assert port_main([str(p), "--no-config", "--engines", "lint"]) == 1
    out = capsys.readouterr().out
    assert "prng-key-reuse" in out and "bad.py" in out
    assert port_main([str(p), "--no-config", "--engines", "lint",
                      "--disable", "prng-key-reuse"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_list_rules_is_the_ports_table(capsys):
    from spark_bagging_tpu_torch.analysis import (
        CONTRACT_CHECKS,
        DET_RULES,
        LOCK_RULES,
    )

    assert port_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    listed = set(re.findall(r"^  (\S+)", out, re.M))
    assert listed == (set(PORT_BAD_GOOD) | set(DET_RULES)
                      | set(CONTRACT_CHECKS) | set(LOCK_RULES))
    assert [ln for ln in out.splitlines() if ln.startswith("[")] == [
        "[lint]", "[determinism]", "[contracts]", "[locks]"]


# -- configuration ----------------------------------------------------------


def test_config_defaults_name_the_port(tmp_path):
    cfg = load_config(str(tmp_path))
    assert cfg == {"paths": ["spark_bagging_tpu_torch", "chip_smoke.py"],
                   "exclude": [], "disable": [], "engines": []}


def test_config_reads_only_the_ports_table(tmp_path):
    (tmp_path / "pyproject.toml").write_text(
        "[tool.sbt-lint]\npaths = ['spark_bagging_tpu']\n"
        "disable = ['jit-in-loop']\n"
        "[tool.sbt-lint-torch]\npaths = ['pkg']\nexclude = ['gen']\n")
    cfg = load_config(str(tmp_path))
    assert cfg["paths"] == ["pkg"] and cfg["exclude"] == ["gen"]
    assert cfg["disable"] == []
    assert load_config(REPO)["paths"] == ["spark_bagging_tpu_torch",
                                          "chip_smoke.py"]


# -- the surface ------------------------------------------------------------


def test_package_surface_equals_jax():
    import spark_bagging_tpu.analysis as ref
    import spark_bagging_tpu_torch.analysis as port

    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert hasattr(port, name), name


def test_analysis_imports_neither_jax_nor_the_jax_package():
    for root, _, files in os.walk(PORT_ANALYSIS):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in ("jax", "jaxlib",
                                       "spark_bagging_tpu"), (path, m)


# -- the self-hosting gate ------------------------------------------------------


def test_repo_tree_is_contract_clean(monkeypatch, capsys):
    """All four engines over the port's tree through the real CLI exit
    0. A finding means either fix it or carry a justified inline
    ``# sbt-lint: disable=<rule>``."""
    import time

    monkeypatch.chdir(REPO)
    t0 = time.perf_counter()
    rc = port_main(["--format", "json"])
    dt = time.perf_counter() - t0
    data = json.loads(capsys.readouterr().out)
    assert rc == 0, "\n".join(
        f"{f['path']}:{f['line']}: [{f['engine']}/{f['rule']}] "
        f"{f['message']}" for f in data["findings"]
    )
    assert data["clean"] is True
    assert list(data["engines"]) == ["lint", "determinism", "contracts",
                                     "locks"]
    assert dt < 15.0, f"full-tree analysis took {dt:.1f}s (budget 15s)"
