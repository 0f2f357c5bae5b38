"""The port's determinism, static-lock and contract engines, held
against the JAX package's:

- ``determinism``: the JAX package's BAD/GOOD fixtures and sanction
  cases (copied) give the same findings — rule, line, column, message —
  in both engines, and the port's rule table is JAX's;
- ``locks_static``: the same for its three rules' fixtures; over the
  port, ``static_edges`` proves the executor -> program-cache seam and
  the fleet's scrape -> merge nesting, the same edge set the JAX engine
  extracts from the JAX package; the dynamic detector's edges on a real
  ``FleetAggregator`` scrape of the port are a subset of the static graph;
- ``contracts``: JAX's miniature repo skeleton and each of its BAD
  mutations (copied), with the package directory renamed and the route
  and verdict tables moved into README.md's port section, give the same
  findings in both engines (paths and the doc's name mapped), except
  for the dropped scenario-baseline check; the port's
  ``faults.UNPORTED_SITES`` is the fault-site check's only exemption,
  and only the README's port section is read.
"""

from __future__ import annotations

import os

import pytest

pytest.importorskip("torch")

from spark_bagging_tpu_torch.analysis import determinism, locks_static  # noqa: E402
from spark_bagging_tpu_torch.analysis.contracts import (  # noqa: E402
    CONTRACT_CHECKS,
    check_repo,
)
from spark_bagging_tpu_torch.analysis.lint import finding_order  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spark_bagging_tpu_torch")


def as_tuples(findings) -> list[tuple]:
    """Findings as comparable tuples, sorted: the JAX engines order two
    findings at one position by set iteration, which varies by process."""
    return sorted((f.rule, f.line, f.col, f.message) for f in findings)


# -- determinism -------------------------------------------------------------

DET_SOURCES = {
    "wallclock_bad": """
import hashlib
import time


def transcript_digest(events):
    h = hashlib.sha256()
    h.update(str(time.time()).encode())
    for e in events:
        h.update(repr(e).encode())
    return h.hexdigest()
""",
    "wallclock_good": """
import hashlib


def transcript_digest(events, now):
    h = hashlib.sha256()
    h.update(str(now).encode())
    for e in events:
        h.update(repr(e).encode())
    return h.hexdigest()
""",
    "rng_bad": """
import hashlib
import random


def sample_digest():
    h = hashlib.sha256()
    h.update(str(random.random()).encode())
    return h.hexdigest()
""",
    "rng_good": """
import hashlib
import random


def sample_digest(seed):
    rng = random.Random(seed)
    h = hashlib.sha256()
    h.update(str(rng.random()).encode())
    return h.hexdigest()
""",
    "identity_bad": """
def stable_order(objs):
    return sorted(objs, key=id)
""",
    "identity_good": """
def stable_order(objs):
    return sorted(objs, key=lambda o: o.name)
""",
    "unordered_bad": """
import hashlib


def digest(names):
    h = hashlib.sha256()
    for n in set(names):
        h.update(n.encode())
    return h.hexdigest()
""",
    "unordered_good": """
import hashlib


def digest(names):
    h = hashlib.sha256()
    for n in sorted(set(names)):
        h.update(n.encode())
    return h.hexdigest()
""",
    "timestamp_key": """
import time


def note(emit_event):
    emit_event({"kind": "drift_alert", "ts": time.time()})
""",
    "snapshot_value_key": """
import time


def snapshot():
    return {"value": time.time()}
""",
    "clock_seam": """
import time


# sbt-lint: clock-seam
def snapshot():
    return {"value": time.time()}
""",
    "now_fill": """
import time


def snapshot(now=None):
    if now is None:
        now = time.time()
    return {"value": now}
""",
    "sorted_launders": """
import hashlib


def digest(names):
    h = hashlib.sha256()
    canon = sorted(set(names))
    for n in canon:
        h.update(n.encode())
    return h.hexdigest()
""",
}


@pytest.mark.parametrize("case", sorted(DET_SOURCES))
def test_determinism_matches_jax(case):
    from spark_bagging_tpu.analysis.determinism import (
        analyze_source as jax_analyze,
    )

    src = DET_SOURCES[case]
    got = as_tuples(determinism.analyze_source(src))
    assert got == as_tuples(jax_analyze(src))
    assert bool(got) == case.endswith(("_bad", "value_key"))


DET_FIXTURES = {
    "det-wallclock-sink": ("wallclock_bad", "wallclock_good"),
    "det-unseeded-rng-sink": ("rng_bad", "rng_good"),
    "det-identity-sink": ("identity_bad", "identity_good"),
    "det-unordered-sink": ("unordered_bad", "unordered_good"),
}


def test_determinism_rule_table_is_jax_and_every_rule_has_fixtures():
    from spark_bagging_tpu.analysis.determinism import DET_RULES

    assert determinism.DET_RULES == DET_RULES
    assert set(DET_FIXTURES) == set(DET_RULES)
    for rule, (bad, good) in DET_FIXTURES.items():
        assert [f.rule for f in determinism.analyze_source(
            DET_SOURCES[bad])] == [rule]
        assert not determinism.analyze_source(DET_SOURCES[good])


def test_determinism_suppression_and_disable():
    bad = DET_SOURCES["wallclock_bad"]
    line = "h.update(str(time.time()).encode())"
    assert not determinism.analyze_source(bad.replace(
        line, line + "  # sbt-lint: disable=det-wallclock-sink"))
    assert not determinism.analyze_source(
        bad, disabled=("det-wallclock-sink",))
    with pytest.raises(KeyError):
        determinism.analyze_source("x = 1\n", enabled=("no-such-rule",))


# -- static locks -------------------------------------------------------------

LOCK_SOURCES = {
    "inversion_bad": """
from spark_bagging_tpu_torch.analysis.locks import make_lock


class Pair:
    def __init__(self):
        self._a = make_lock("fix.a")
        self._b = make_lock("fix.b")

    def forward(self):
        with self._a:
            with self._b:
                pass

    def backward(self):
        with self._b:
            with self._a:
                pass
""",
    "inversion_good": """
from spark_bagging_tpu_torch.analysis.locks import make_lock


class Pair:
    def __init__(self):
        self._a = make_lock("fix.a")
        self._b = make_lock("fix.b")

    def forward(self):
        with self._a:
            with self._b:
                pass

    def also_forward(self):
        with self._a:
            with self._b:
                pass
""",
    "nested_bad": """
from spark_bagging_tpu_torch.analysis.locks import make_lock


class Box:
    def __init__(self):
        self._lock = make_lock("fix.box")

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            pass
""",
    "nested_good": """
from spark_bagging_tpu_torch.analysis.locks import make_lock


class Box:
    def __init__(self):
        self._lock = make_lock("fix.box", rlock=True)

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            pass
""",
    "check_then_act_bad": """
from spark_bagging_tpu_torch.analysis.locks import make_lock


class Once:
    def __init__(self):
        self._lock = make_lock("fix.once")
        self._closed = False

    def poke(self):
        with self._lock:
            self._closed = False

    def close(self):
        if self._closed:
            return
        self._closed = True
""",
    "check_then_act_good": """
from spark_bagging_tpu_torch.analysis.locks import make_lock


class Once:
    def __init__(self):
        self._lock = make_lock("fix.once")
        self._closed = False

    def poke(self):
        with self._lock:
            self._closed = False

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
""",
    "direct_nesting_bad": """
from spark_bagging_tpu_torch.analysis.locks import make_lock

_l = make_lock("fix.mod")


def f():
    with _l:
        with _l:
            pass
""",
    "nested_def_good": """
from spark_bagging_tpu_torch.analysis.locks import make_lock

_a = make_lock("fix.na")
_b = make_lock("fix.nb")


def f():
    with _a:
        def worker():
            with _b:
                pass
        return worker
""",
}


@pytest.mark.parametrize("case", sorted(LOCK_SOURCES))
def test_static_locks_match_jax(case):
    from spark_bagging_tpu.analysis.locks_static import (
        analyze_source as jax_analyze,
    )

    src = LOCK_SOURCES[case]
    got = as_tuples(locks_static.analyze_source(src, "fixture.py"))
    assert got == as_tuples(jax_analyze(src, "fixture.py"))
    assert bool(got) == case.endswith("_bad")


def test_lock_rule_table_is_jax():
    from spark_bagging_tpu.analysis.locks_static import LOCK_RULES

    assert locks_static.LOCK_RULES == LOCK_RULES


@pytest.fixture(scope="module")
def port_edges():
    return set(locks_static.static_edges([PKG]))


def test_static_graph_proves_the_ports_seams(port_edges, tmp_path,
                                             monkeypatch):
    """The cross-file resolution over the port: the executor's build
    holds its build lock while going through the program cache module
    alias; the fleet's scrape holds its scrape lock into the merge. The
    graph is the JAX engine's over the JAX package, and independent of
    the working directory."""
    from spark_bagging_tpu.analysis.locks_static import (
        static_edges as jax_edges,
    )

    assert ("serving.executor.build", "serving.program_cache") in port_edges
    assert ("telemetry.fleet.scrape", "telemetry.fleet") in port_edges
    assert port_edges == set(jax_edges([os.path.join(REPO,
                                                     "spark_bagging_tpu")]))
    monkeypatch.chdir(tmp_path)
    sites = locks_static.edge_sites([PKG])
    assert set(sites) == port_edges
    for (a, b), (path, line) in sites.items():
        assert os.path.isfile(path) and line > 0, (a, b, path)


def test_static_vs_dynamic_agreement(port_edges):
    """observed ⊆ static over the port's real FleetAggregator scrape."""
    from spark_bagging_tpu_torch.analysis import locks
    from spark_bagging_tpu_torch.telemetry.fleet import FleetAggregator

    class _Peer:
        name = "p0"

        def scrape(self):
            return {"metrics": []}

    locks.clear()
    locks.enable(True, strict=False)
    try:
        agg = FleetAggregator([_Peer()], interval_s=0.0)
        agg.scrape_all(now=0.0)
        agg.scrape_all(now=10.0)
        observed = set(locks.acquisition_edges())
    finally:
        locks.enable(False)
        locks.clear()
    assert ("telemetry.fleet.scrape", "telemetry.fleet") in observed
    assert observed <= port_edges, sorted(observed - port_edges)


# -- contracts ---------------------------------------------------------------

# the JAX package's skeleton (tests/test_analysis_contracts.py, copied)
_SKELETON = {
    "spark_bagging_tpu/telemetry/registry.py": '''\
SERIES_HELP = {
    "sbt_requests_total": "requests (unlabeled total + label tenant)",
    "sbt_queue_depth": "queue depth",
}
''',
    "spark_bagging_tpu/faults.py": '''\
SITES = {
    "serving.submit": "the submit path",
}
''',
    "spark_bagging_tpu/telemetry/recorder.py": '''\
TRIGGER_KINDS = ("drift_alert",)
TIMELINE_KINDS = TRIGGER_KINDS + ("model_swapped",)
''',
    "spark_bagging_tpu/telemetry/alerts.py": '''\
def default_drift_rules():
    return [AlertRule("queue-deep", "sbt_queue_depth", 10.0)]
''',
    "spark_bagging_tpu/telemetry/server.py": '''\
def do_GET(self, url):
    if url.path == "/metrics":
        return self._metrics()
    return {"endpoints": ["/metrics"]}
''',
    "spark_bagging_tpu/telemetry/perf.py": '''\
VERDICTS = ("failed", "queue-dominated")
''',
    "spark_bagging_tpu/app.py": '''\
def work(telemetry, faults):
    telemetry.inc("sbt_requests_total")
    telemetry.inc("sbt_requests_total", labels={"tenant": "a"})
    telemetry.set_gauge("sbt_queue_depth", 1)
    faults.fire("serving.submit")
    return [{"kind": "drift_alert"}, {"kind": "model_swapped"}]
''',
    "benchmarks/scenarios/__init__.py": '''\
def _register_all(register, Scenario):
    register(Scenario(name="smoke"))
''',
    "benchmarks/baselines/scenarios/smoke.json": "{}\n",
    "ARCHITECTURE.md": """\
# mini

| route | serves | semantics |
|---|---|---|
| `/metrics` | text | the scrape endpoint |

| verdict | evidence |
|---|---|
| `failed` | the record carries an error |
| `queue-dominated` | queue wait dominates |
""",
}

_APP = _SKELETON["spark_bagging_tpu/app.py"]
_ARCH = _SKELETON["ARCHITECTURE.md"]

# JAX's BAD mutations (copied) of the checks the port keeps
BAD_CASES = {
    "contract-series-help": [
        ({"spark_bagging_tpu/app.py": _APP
          + '\n\ndef more(telemetry):\n'
            '    telemetry.inc("sbt_ghost_total")\n'},
         "no SERIES_HELP entry"),
        ({"spark_bagging_tpu/telemetry/registry.py": '''\
SERIES_HELP = {
    "sbt_requests_total": "requests (unlabeled total + label tenant)",
    "sbt_queue_depth": "queue depth",
    "sbt_dead_series": "documented, never emitted",
}
'''},
         "no emit site"),
    ],
    "contract-series-twins": [
        ({"spark_bagging_tpu/app.py": '''\
def work(telemetry, faults):
    telemetry.inc("sbt_requests_total")
    telemetry.set_gauge("sbt_queue_depth", 1)
    faults.fire("serving.submit")
    return [{"kind": "drift_alert"}, {"kind": "model_swapped"}]
'''},
         "no LABELED emit site"),
        ({"spark_bagging_tpu/app.py": '''\
def work(telemetry, faults):
    telemetry.inc("sbt_requests_total", labels={"tenant": "a"})
    telemetry.set_gauge("sbt_queue_depth", 1)
    faults.fire("serving.submit")
    return [{"kind": "drift_alert"}, {"kind": "model_swapped"}]
'''},
         "no UNLABELED emit site"),
    ],
    "contract-fault-sites": [
        ({"spark_bagging_tpu/app.py": _APP
          + '\n\ndef more(faults):\n'
            '    faults.fire("serving.ghost")\n'},
         "no faults.SITES entry"),
        ({"spark_bagging_tpu/faults.py": '''\
SITES = {
    "serving.submit": "the submit path",
    "serving.dead": "registered, never fired",
}
'''},
         "no live fire() call"),
    ],
    "contract-recorder-kinds": [
        ({"spark_bagging_tpu/telemetry/recorder.py": '''\
TRIGGER_KINDS = ("drift_alert", "ghost_kind")
TIMELINE_KINDS = TRIGGER_KINDS + ("model_swapped",)
'''},
         "never emitted"),
    ],
    "contract-alert-rules": [
        ({"spark_bagging_tpu/telemetry/alerts.py": '''\
def default_drift_rules():
    return [AlertRule("ghost", "sbt_missing_series", 1.0)]
'''},
         "does not exist"),
    ],
    "contract-http-routes": [
        ({"spark_bagging_tpu/telemetry/server.py": '''\
def do_GET(self, url):
    if url.path == "/metrics":
        return self._metrics()
    if url.path == "/hidden":
        return self._hidden()
    return {"endpoints": ["/metrics"]}
'''},
         "missing from the ARCHITECTURE.md route table"),
        ({"ARCHITECTURE.md": _ARCH.replace(
            "| `/metrics` | text | the scrape endpoint |",
            "| `/metrics` | text | the scrape endpoint |\n"
            "| `/ghost` | json | promised, never dispatched |")},
         "not dispatched"),
        ({"spark_bagging_tpu/telemetry/server.py": '''\
def do_GET(self, url):
    if url.path == "/metrics":
        return self._metrics()
    return {"endpoints": ["/metrics", "/phantom"]}
'''},
         "advertises an endpoint"),
    ],
    "contract-tail-verdicts": [
        ({"spark_bagging_tpu/telemetry/perf.py": '''\
VERDICTS = ("failed", "queue-dominated", "wfq-starved")
'''},
         "missing from the ARCHITECTURE.md verdict-ladder table"),
        ({"ARCHITECTURE.md": _ARCH
          + "| `ghost-verdict` | promised, never emitted |\n"},
         "is not in"),
    ],
}

_CASES = [("skeleton", None)] + [
    (check, i) for check in sorted(BAD_CASES)
    for i in range(len(BAD_CASES[check]))]


def _write(root, files) -> str:
    for rel, content in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(content)
    return str(root)


def _port_files(files: dict) -> dict:
    """The JAX skeleton as the port's repo: the package renamed, the
    doc tables in README.md's port section (one heading line for
    ARCHITECTURE.md's, so every table row keeps its line)."""
    out = {}
    for rel, content in files.items():
        if rel.startswith("benchmarks/"):
            continue
        if rel == "ARCHITECTURE.md":
            out["README.md"] = content.replace("# mini",
                                               "## PyTorch / H100 port", 1)
            continue
        out[rel.replace("spark_bagging_tpu/",
                        "spark_bagging_tpu_torch/", 1)] = content
    return out


def _normalized(findings) -> list[tuple]:
    return sorted((f.rule, f.path.replace("spark_bagging_tpu_torch",
                                          "spark_bagging_tpu")
                   .replace("README.md", "ARCHITECTURE.md"), f.line, f.col,
                   f.message.replace("README.md", "ARCHITECTURE.md"))
                  for f in findings)


@pytest.mark.parametrize("check,i", _CASES,
                         ids=[f"{c}-{i}" for c, i in _CASES])
def test_contracts_match_jax_on_its_skeleton(tmp_path, check, i):
    from spark_bagging_tpu.analysis.contracts import (
        check_repo as jax_check,
    )

    files = dict(_SKELETON)
    fragment = None
    if check != "skeleton":
        overrides, fragment = BAD_CASES[check][i]
        files.update(overrides)
    jax_root = _write(tmp_path / "jax", files)
    port_root = _write(tmp_path / "port", _port_files(files))
    ref = [f for f in jax_check(jax_root)
           if f.rule != "contract-scenario-baselines"]
    got = check_repo(port_root)
    assert _normalized(got) == sorted(
        (f.rule, f.path, f.line, f.col, f.message) for f in ref)
    # the port's report order breaks ties on the message: one order in
    # every process
    assert [finding_order(f) for f in got] == sorted(
        finding_order(f) for f in got)
    if fragment is None:
        assert not got, "\n".join(f.render() for f in got)
    else:
        assert any(fragment in m for _, _, _, _, m in _normalized(got))


def test_every_kept_check_has_a_bad_case_and_the_dropped_one_is_gone():
    from spark_bagging_tpu.analysis.contracts import (
        CONTRACT_CHECKS as JAX_CHECKS,
    )

    assert set(CONTRACT_CHECKS) == set(BAD_CASES)
    assert set(JAX_CHECKS) - set(CONTRACT_CHECKS) == {
        "contract-scenario-baselines"}


_UNPORTED_FAULTS = '''\
SITES = {
    "serving.submit": "the submit path",
    "aot.load": "a reference-only seam",
}

UNPORTED_SITES = ("aot.load",)
'''


@pytest.mark.parametrize("case,fragment", [
    ("declared", None),
    ("fired", "fires a seam declared in faults.UNPORTED_SITES"),
    ("not_a_site", "is not a faults.SITES key"),
    ("undeclared", "no live fire() call"),
])
def test_unported_sites_are_the_only_fault_site_exemption(tmp_path, case,
                                                           fragment):
    files = _port_files(dict(_SKELETON))
    faults = _UNPORTED_FAULTS
    if case == "fired":
        files["spark_bagging_tpu_torch/app.py"] += (
            '\n\ndef more(faults):\n    faults.fire("aot.load")\n')
    elif case == "not_a_site":
        faults = faults.replace('("aot.load",)', '("aot.load", "aot.save")')
    elif case == "undeclared":
        faults = faults.replace('("aot.load",)', '()')
    files["spark_bagging_tpu_torch/faults.py"] = faults
    found = check_repo(_write(tmp_path, files),
                       checks=["contract-fault-sites"])
    if fragment is None:
        assert not found, "\n".join(f.render() for f in found)
    else:
        assert any(fragment in f.message for f in found), found


def test_only_the_readme_port_section_is_read(tmp_path):
    files = _port_files(dict(_SKELETON))
    files["README.md"] = ("# repo\n\n## Elsewhere\n\n"
                          + files["README.md"].split("\n", 1)[1]
                          + "\n## PyTorch / H100 port\n\nno tables\n")
    found = check_repo(_write(tmp_path, files),
                       checks=["contract-http-routes",
                               "contract-tail-verdicts"])
    assert sorted(f.message.split(" — ")[0] for f in found) == [
        "could not locate the `| route | serves | semantics |` table",
        "could not locate the `| verdict | evidence |` table"]


def test_the_ports_tree_declares_its_unported_seams():
    """The port's declaration (the tree's contract-clean gate is
    tests/test_torch_analysis.py::test_repo_tree_is_contract_clean)."""
    from spark_bagging_tpu_torch import faults

    assert faults.UNPORTED_SITES == ("aot.save", "aot.load")
    assert set(faults.UNPORTED_SITES) <= set(faults.SITES)
