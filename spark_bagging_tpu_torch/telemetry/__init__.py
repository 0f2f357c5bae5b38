"""Telemetry: the metrics registry, spans, event sinks, and the
quality, capacity, performance, fleet and exposition planes.

The port's copy of the JAX package's telemetry core, which the serving
plane, the checkpoint writer, the fault injector and the online trainer
emit through:

1. **Registry** (``registry.py``) — process-wide, thread-safe counters,
   gauges and log-scale histograms (``sbt_*`` metric names), with
   Prometheus text rendering (``render_prometheus``).
2. **Spans** (``spans.py``) — nestable phase spans
   (``with telemetry.span("serving_forward"): ...``) recording
   wall-clock per phase; inside an open ``torch.profiler`` session a
   span is also a profiler range, and ``phase()`` always is one.
   Device-sync timing is opt-in.
3. **Sinks** (``sinks.py``) — ``capture()`` opens a run whose events
   (spans, metric flushes, serving fault events) land in memory and,
   optionally, a schema-versioned JSONL file.
4. **Request tracing** (``tracing.py``) — per-request trace contexts
   threading the serving path (every served future exposes
   ``future.trace`` with a queue/batch/forward timing breakdown).
5. **Recorders** (``recorder.py`` / ``workload.py``) — a ring-buffer
   flight recorder that dumps ``flight_<ts>_<seq>.json`` on serving
   faults, fired alerts and rejected refits, and a workload recorder
   that turns the ``serving_request`` arrival stream into a
   ``*.workload.jsonl`` file (the JAX package's format).
6. **Model-quality plane** (``quality.py`` / ``alerts.py``) —
   streaming drift detection against a fit-time reference profile
   (``sbt_quality_*`` PSI/KS gauges, ensemble-disagreement sampling
   through one CUDA graph a bucket) plus a declarative burn-rate alert
   engine over live registry series (``sbt_alerts_*``; ``alert_fired``
   events trigger the flight recorder and the online trainer).
7. **Operator's planes** — the capacity ledger (``capacity.py``: what
   each resident model holds in device bytes, its CUDA-graph programs'
   pool bytes and its parameters, and the demand that justifies them),
   performance attribution (``perf.py``: per-stage request time, a
   per-bucket cost model with FLOPs counted at each bucket's build,
   serving MFU, the tail explainer), SLO gates (``slo.py``), the
   longitudinal history (``history.py``), the fleet merge of several
   processes' ``/varz`` (``fleet.py``), and the opt-in stdlib HTTP
   exposition server (``server.py``: ``/metrics``, ``/healthz``,
   ``/varz``, ``/debug/*``, ``/alerts``, ``/fleet/*``; start with
   ``SBT_METRICS_PORT`` or :func:`start_server`) with its CLI
   (``python -m spark_bagging_tpu_torch.telemetry dump|profile``).
8. **The fit report** — ``fit_report_`` is a :class:`FitReportView`
   built by :func:`record_fit_report`: a plain dict whose numeric
   entries are ``sbt_fit_<key>`` gauges.

The tenancy plane (``tenancy/``: admission, fair queuing, residency,
refit budgets, quarantine) is a package of its own; it exports the
``sbt_tenancy_*`` / ``sbt_tenant_*`` series, and ``/debug/tenancy``
serves its installed fleet's report.

Cost contract: **zero overhead when disabled** — every instrumentation
site guards on :func:`enabled` (one attribute read) or goes through
:func:`span`, which returns a shared no-op context manager when
disabled. Host-side counters are ON by default; the event stream only
materializes inside an open :func:`capture`.
"""

from __future__ import annotations

from spark_bagging_tpu_torch.telemetry import tracing
from spark_bagging_tpu_torch.telemetry.registry import (
    QUANTILES,
    Registry,
    SERIES_HELP,
    render_prometheus as _render_snapshot,
)
from spark_bagging_tpu_torch.telemetry.sinks import (
    SCHEMA_VERSION,
    Run,
    capture,
    capture_open as _capture_open,
    current_run,
    default_log_path,
    last_metrics_snapshot,
    read_events,
    runs,
    telemetry_dir,
)
from spark_bagging_tpu_torch.telemetry.spans import phase, span
from spark_bagging_tpu_torch.telemetry.state import STATE as _state
from spark_bagging_tpu_torch.telemetry import (
    alerts,
    fleet,
    history,
    perf,
    quality,
    recorder,
    slo,
    workload,
)

# the exposition server's names resolve lazily (module __getattr__
# below): its http.server import chain costs ~100ms of stdlib, which
# `import spark_bagging_tpu_torch` consumers that never serve must not
# pay
_SERVER_ATTRS = ("start_server", "stop_server", "server_address")

__all__ = [
    "SCHEMA_VERSION", "SERIES_HELP", "QUANTILES", "Run", "capture",
    "current_run", "enabled", "enable", "disable", "set_device_sync",
    "device_sync_enabled", "span", "phase", "inc", "inc_many",
    "set_gauge",
    "observe", "emit_event", "registry", "render_prometheus",
    "read_events", "last_metrics_snapshot", "runs",
    "record_fit_report", "Registry", "reset", "telemetry_dir",
    "default_log_path", "tracing", "recorder", "workload", "slo",
    "quality", "alerts", "fleet", "perf", "history",
    "sinks_active", "arrival_events_wanted", "start_server",
    "stop_server", "server_address",
]


def enabled() -> bool:
    """THE hot-path gate: every instrumentation site checks this (or
    calls :func:`span`, which does) before doing any work."""
    return _state.enabled


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    """Turn all telemetry recording off (the profiler ranges of
    :func:`phase` remain)."""
    _state.enabled = False


def set_device_sync(on: bool) -> None:
    """Opt span timing into device barriers at span entry/exit so the
    recorded wall-clock covers device work launched inside the span
    (off by default: the barrier serializes the pipeline it measures)."""
    _state.device_sync = bool(on)


def device_sync_enabled() -> bool:
    return _state.device_sync


def sinks_active() -> bool:
    """True when at least one event sink is attached (an open capture,
    the armed flight recorder, a workload recorder)."""
    return bool(_state._sinks)


def arrival_events_wanted() -> bool:
    """True when a sink that actually CONSUMES ``serving_request``
    arrival events is attached: a recording workload recorder or an
    open ``capture()`` window. The batcher's submit path gates event
    construction on this rather than on :func:`sinks_active` — a
    serving deployment keeps the flight recorder armed for its whole
    lifetime, and that sink deliberately ignores arrival events, so
    gating on "any sink" would charge every request for a dict nothing
    reads. Runs per submit: no imports, two module-int reads."""
    return workload.capture_active() or _capture_open()


def registry() -> Registry:
    """The process-wide metrics registry."""
    return _state.registry


def reset() -> None:
    """Clear the registry (tests; a long-lived service rotating runs)."""
    _state.registry.reset()


# -- counter convenience wrappers (no-ops when disabled) ---------------

def inc(name: str, v: float = 1.0, labels: dict | None = None) -> None:
    if _state.enabled:
        _state.registry.inc(name, v, labels)


def inc_many(items) -> None:
    """Increment several unlabeled counters in one registry lock
    round-trip (hot-path fusion; see ``Registry.inc_many``)."""
    if _state.enabled:
        _state.registry.inc_many(items)


def set_gauge(name: str, v: float, labels: dict | None = None) -> None:
    if _state.enabled:
        _state.registry.set(name, v, labels)


def observe(name: str, v: float, labels: dict | None = None,
            exemplar: str | None = None) -> None:
    if _state.enabled:
        _state.registry.observe(name, v, labels, exemplar=exemplar)


def emit_event(event: dict) -> None:
    """Deliver one raw event to every active sink (open captures, the
    armed flight recorder). The serving fault events
    (``serving_batch_error``, ``serving_overloaded``,
    ``swap_rejected``) and the trainer's ``refit_rejected`` go through
    here — they are flight-recorder triggers, not metrics. No-op (one
    attribute read + an empty-list check) when disabled or nothing is
    listening."""
    if _state.enabled and _state._sinks:
        import time

        event.setdefault("ts", time.time())
        _state.emit(event)


def render_prometheus(snapshot: list | None = None) -> str:
    """Prometheus text exposition of the registry (or a snapshot
    previously read back from a JSONL log's ``metrics`` event)."""
    if snapshot is None:
        snapshot = _state.registry.snapshot()
    return _render_snapshot(snapshot)


# -- fit_report integration --------------------------------------------

class FitReportView(dict):
    """``fit_report_`` as a view over the run registry: a plain dict to
    every consumer (its keys are the JAX package's report keys), whose
    numeric entries were exported to the registry as ``sbt_fit_<key>``
    gauges at construction. Mutations after construction flow back
    through ``__setitem__`` so the registry view never goes stale."""

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        if _state.enabled and isinstance(value, (int, float)) \
                and not isinstance(value, bool):
            _state.registry.set(f"sbt_fit_{key}", float(value))


def record_fit_report(report: dict) -> FitReportView:
    """Register a freshly assembled fit report with the telemetry
    subsystem and return the registry-backed view of it.

    Exports every numeric entry as an ``sbt_fit_<key>`` gauge, bumps
    the headline counters (``sbt_replicas_fitted_total``), folds
    compile/fit/h2d seconds into their log-scale histograms, and emits
    one ``fit_report`` event into any open capture.
    """
    view = FitReportView()
    if not _state.enabled:
        view.update(report)
        return view
    for k, v in report.items():
        view[k] = v  # __setitem__ exports numerics as gauges
    reg = _state.registry
    n = report.get("n_replicas") or 0
    if n:
        reg.inc("sbt_replicas_fitted_total", float(n))
    for key, metric in (
        ("compile_seconds", "sbt_compile_seconds"),
        ("fit_seconds", "sbt_fit_seconds"),
        ("h2d_seconds", "sbt_h2d_seconds"),
    ):
        val = report.get(key)
        if val is not None:
            reg.observe(metric, float(val))
    _state.emit({"kind": "fit_report", "report": dict(report)})
    return view


def __getattr__(name: str):
    if name in _SERVER_ATTRS:
        from spark_bagging_tpu_torch.telemetry import server

        return getattr(server, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )


# -- live observability plane (opt-in) ---------------------------------
# `SBT_METRICS_PORT=9100 python your_serving_script.py` is the whole
# enable story: the exposition server starts with the package and
# `curl :9100/healthz` works with zero code changes. Without the env
# var this is one dict lookup at import (server.py stays unimported).
import os as _os  # noqa: E402

if _os.environ.get("SBT_METRICS_PORT", ""):
    from spark_bagging_tpu_torch.telemetry.server import (  # noqa: E402
        maybe_start_from_env as _maybe_start_from_env,
    )

    _maybe_start_from_env()
