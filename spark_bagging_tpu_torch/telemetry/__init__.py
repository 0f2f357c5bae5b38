"""Telemetry: the metrics registry, spans, event sinks and the
model-quality plane.

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

Not ported yet (ROADMAP Queue A 15, part 2): the capacity plane
(``capacity.py``), the performance-attribution, SLO, history and fleet
planes, the exposition server with ``/healthz`` and the ``__main__``
CLI, and the registry-backed ``fit_report_`` view
(``FitReportView``, ``record_fit_report``).

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
    quality,
    recorder,
    workload,
)

__all__ = [
    "SCHEMA_VERSION", "SERIES_HELP", "QUANTILES", "Run", "capture",
    "current_run", "enabled", "enable", "disable", "set_device_sync",
    "device_sync_enabled", "span", "phase", "inc", "inc_many",
    "set_gauge", "observe", "emit_event", "registry",
    "render_prometheus", "read_events", "last_metrics_snapshot", "runs",
    "Registry", "reset", "telemetry_dir", "default_log_path", "tracing",
    "recorder", "workload", "quality", "alerts", "sinks_active",
    "arrival_events_wanted",
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
