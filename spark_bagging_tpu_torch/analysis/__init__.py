"""Static-analysis subsystem of the port (``sbt-lint``): AST lint, graph
audit, lock-order detection — the reference package's ``analysis/``,
pointed at the port.

Engines, one goal — catch the failure modes of a threaded torch/CUDA
serving path that survive unit tests and only surface under load:

- :mod:`~spark_bagging_tpu_torch.analysis.lint` + ``analysis/rules/``:
  source-level rules (host syncs in spans and CUDA-graph captures, PRNG
  hygiene over the port's explicit keys, unlocked shared state,
  swallowed faults, hot-path allocations), with per-line suppressions
  and a CLI (``python -m spark_bagging_tpu_torch.analysis``).
- :mod:`~spark_bagging_tpu_torch.analysis.graph_audit`: traces the REAL
  serving closures with ``make_fx`` and asserts no host syncs, no
  wide-dtype promotion and bounded baked constants, and lists the
  hand-written kernels the trace launched.
- :mod:`~spark_bagging_tpu_torch.analysis.locks`: instrumented locks
  that record the acquisition graph and flag order cycles and
  held-across-device-sync hazards (``SBT_LOCK_DEBUG=1``); the serving
  plane and the telemetry registry take their locks from it.
- :mod:`~spark_bagging_tpu_torch.analysis.determinism`: AST dataflow
  pass tracking nondeterminism sources (wall-clock, unseeded RNG,
  object identity, unordered iteration) into determinism sinks
  (digests, event logs, snapshots, sort keys).
- :mod:`~spark_bagging_tpu_torch.analysis.contracts`: whole-repo
  cross-artifact checks — SERIES_HELP completeness, faults.fire ↔
  SITES, recorder kinds, alert-rule series, HTTP routes and tail
  verdicts ↔ README.md's port section.
- :mod:`~spark_bagging_tpu_torch.analysis.locks_static`: static
  extraction of the make_lock acquisition graph with inversion and
  check-then-act findings, cross-validated against the dynamic
  detector.

The static engines import no torch: linting reads source only.
"""

from spark_bagging_tpu_torch.analysis import locks
from spark_bagging_tpu_torch.analysis.contracts import (
    CONTRACT_CHECKS,
    check_repo,
)
from spark_bagging_tpu_torch.analysis.determinism import DET_RULES
from spark_bagging_tpu_torch.analysis.determinism import (
    analyze_paths as determinism_paths,
)
from spark_bagging_tpu_torch.analysis.determinism import (
    analyze_source as determinism_source,
)
from spark_bagging_tpu_torch.analysis.graph_audit import (
    AuditError,
    AuditReport,
    audit_estimator,
    audit_executor,
    audit_fn,
)
from spark_bagging_tpu_torch.analysis.lint import (
    RULES,
    Finding,
    lint_file,
    lint_paths,
    lint_source,
    load_config,
    render_json,
    render_text,
)
from spark_bagging_tpu_torch.analysis.locks_static import (
    LOCK_RULES,
    edge_sites,
    static_edges,
)

__all__ = [
    "AuditError",
    "AuditReport",
    "audit_estimator",
    "audit_executor",
    "audit_fn",
    "CONTRACT_CHECKS",
    "DET_RULES",
    "Finding",
    "LOCK_RULES",
    "RULES",
    "check_repo",
    "determinism_paths",
    "determinism_source",
    "edge_sites",
    "lint_file",
    "lint_paths",
    "lint_source",
    "load_config",
    "locks",
    "render_json",
    "render_text",
    "static_edges",
]
