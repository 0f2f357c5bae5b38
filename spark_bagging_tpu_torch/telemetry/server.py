"""Live exposition server — scrape the process instead of reading dumps.

Everything before this was passive observability: an in-process
registry plus offline JSONL/Prometheus dumps. This module is the live
half — a zero-dependency stdlib ``http.server`` endpoint an operator
(or a Prometheus scraper, or ``curl``) points at a serving process:

- ``GET /metrics`` — the registry in Prometheus text exposition
  format, straight off the live process (``# HELP``/``# TYPE`` lines
  included);
- ``GET /healthz`` — aggregate liveness from every registered health
  source (micro-batcher queue depth vs. bound, last-batch age, closed
  flag; model registry live versions). 200 when every source is
  healthy, 503 otherwise — load-balancer-compatible;
- ``GET /varz`` — one JSON snapshot: metrics (with per-histogram
  p50/p95/p99 quantiles and exemplar trace ids), health detail,
  process info;
- ``GET /debug/spans`` — recent span events from the flight
  recorder's ring (``?trace_id=`` filters to one request's tree);
- ``GET /debug/runs`` — the run registry (every ``capture()`` window
  this process opened);
- ``GET /debug/workload`` — the active workload recorder's capture
  summary (request count, duration, rps, epochs) while recording is
  on — the live view of the record half of record→replay→report;
- ``GET /alerts`` — the process-default alert engine's rule states
  (active alerts, fire/resolve/suppress counts); each scrape runs one
  evaluation pass, so a Prometheus-less deployment still gets alert
  transitions just by polling;
- ``GET /debug/drift`` — every attached quality monitor's drift
  summary (per-feature PSI/KS vs the training reference, live
  medians, disagreement stats);
- ``GET /debug/tail`` — the tail-latency explainer
  (``telemetry/perf.py``): the slowest retained requests, each joined
  against the flight recorder's concurrent events into a verdict
  (queue-dominated / compile-absorbed / retry-inflated /
  degraded-path / genuinely-slow-forward);
- ``GET /debug/history`` — the longitudinal verification history
  (``telemetry/history.py``): the newest trend-store records
  (scenario/bench/tier runs) plus the ``compare_trend`` verdict over
  the full store — digest flips are findings, noise-band numeric
  wobble is not;
- ``GET /debug/capacity`` — the capacity & residency plane
  (``telemetry/capacity.py``): per-owner ledger reconciled against
  the program cache, the per-resident eviction-decision explainer
  (LRU position, demand rank/class, bytes reclaimable, last-hit age),
  demand table, recent owner-attributed evictions, device memory;
- ``GET /debug/tenancy`` — the installed tenant fleet's report
  (``tenancy/fleet.py``: admission, WFQ, residency, refit budget,
  quarantine), or ``{"enabled": false}`` with no fleet installed;
- ``GET /debug/profile?seconds=N`` — on-demand live device profiling:
  starts a single-flight ``torch.profiler`` capture (the host's ops and
  the card's kernels and graph launches, every thread of the process)
  that auto-stops after N seconds (hard-capped) and writes a Chrome
  trace, ``trace.json``, under ``telemetry_dir()/profiles/``; 409
  while one is already running, ``?action=stop`` ends it early;
- ``GET /fleet/metrics`` / ``/fleet/varz`` / ``/fleet/healthz`` /
  ``/fleet/incidents`` — the fleet plane (``telemetry/fleet.py``):
  when a :class:`~spark_bagging_tpu_torch.telemetry.fleet.FleetAggregator`
  is installed, each scrape ticks it (interval-limited) and serves
  the exactly-merged N-process view — summed counters,
  ``process=``-labeled gauges, bucket-merged histograms with exact
  fleet quantiles, quorum health over peer healthz + scrape
  staleness, and the correlated incident timeline.

Opt-in, two ways: ``telemetry.start_server(port)`` from code, or the
``SBT_METRICS_PORT`` environment variable (checked at package import;
port 0 picks an ephemeral port). The server runs on one daemon thread
(requests themselves are handled on short-lived threads); when it is
not started, nothing in this module runs — the serving hot path's
zero-overhead contract is untouched. Binds loopback by default:
metrics can leak data shapes and model names, so exposing beyond the
host is a deliberate ``host=`` choice.

Health sources register WEAKLY: a batcher garbage-collected with its
serving stack disappears from ``/healthz`` instead of pinning the
object alive or reporting a ghost. A closed-but-referenced batcher
reports unhealthy by design — drop the reference once it is retired.
(Close first: an un-closed batcher's worker thread holds a strong
reference to it, so abandoning one without ``close()``/``retire()``
leaks the thread AND keeps its health entry live.)

The port's copy of the JAX package's ``telemetry/server.py``. A scrape
runs on a handler thread beside the serving threads' graph replays and
a swap's thread-local captures: it reads allocator counters and host
state only, and never touches a device tensor or synchronizes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse
import weakref

from spark_bagging_tpu_torch.analysis.locks import make_lock

_module_lock = make_lock("telemetry.server")
_server: ThreadingHTTPServer | None = None
_thread: threading.Thread | None = None
_t_start: float | None = None

# handle -> (source name, weakref to owner, bound health fn taking the
# live owner). Owner death removes the entry lazily on read.
_health_sources: dict[int, tuple[str, Any, Callable[[Any], dict]]] = {}
_health_seq = [0]


def register_health_source(
    name: str, owner: Any, fn: Callable[[Any], dict],
) -> int:
    """Register ``fn(owner) -> dict`` as a ``/healthz`` contributor.

    The dict must carry ``healthy: bool``; everything else is detail
    surfaced verbatim. ``owner`` is held by weak reference. Returns a
    handle for :func:`remove_health_source`.
    """
    with _module_lock:
        # prune dead owners here too, not only in health_report():
        # a process that never serves /healthz (no server started)
        # but churns through batchers must not grow this dict forever
        for h in [h for h, (_, r, _f) in _health_sources.items()
                  if r() is None]:
            del _health_sources[h]
        _health_seq[0] += 1
        handle = _health_seq[0]
        _health_sources[handle] = (name, weakref.ref(owner), fn)
    return handle


def remove_health_source(handle: int) -> None:
    with _module_lock:
        _health_sources.pop(handle, None)


def clear_health_sources() -> None:
    """Drop every registered source (test isolation; embedders that
    rebuild their serving stack in-process)."""
    with _module_lock:
        _health_sources.clear()


def health_report() -> dict[str, Any]:
    """Aggregate health: ``{"healthy": bool, "sources": {...}}``.
    Healthy when every live source is (an empty source set is healthy:
    nothing is wrong, there is just nothing serving yet)."""
    with _module_lock:
        items = list(_health_sources.items())
    sources: dict[str, dict] = {}
    healthy = True
    dead: list[int] = []
    for handle, (name, ref, fn) in items:
        owner = ref()
        if owner is None:
            dead.append(handle)
            continue
        try:
            detail = dict(fn(owner))
        # sbt-lint: disable=swallowed-fault — the fault IS the report: surfaced as healthy=False with the error in the /healthz body
        except Exception as e:  # noqa: BLE001 — a broken health probe
            # IS unhealth, not a reason to take the endpoint down
            detail = {"healthy": False, "error": repr(e)}
        healthy = healthy and bool(detail.get("healthy"))
        sources[f"{name}#{handle}"] = detail
    if dead:
        with _module_lock:
            for handle in dead:
                _health_sources.pop(handle, None)
    return {"healthy": healthy, "sources": sources}


def _refresh_process_gauges() -> tuple[float | None, int | None]:
    """Sample uptime + RSS and mirror them as ``sbt_process_*``
    registry gauges. Called from BOTH exposition routes — a
    Prometheus deployment that only ever scrapes ``/metrics`` (the
    normal setup) must see fresh values, not ones frozen at the last
    manual ``/varz`` curl. Returns the pair for ``/varz``'s JSON."""
    from spark_bagging_tpu_torch.telemetry.state import STATE
    from spark_bagging_tpu_torch.utils.memory import host_rss_bytes

    uptime = (time.monotonic() - _t_start
              if _t_start is not None else None)
    rss = host_rss_bytes()
    if STATE.enabled:
        if uptime is not None:
            STATE.registry.set("sbt_process_uptime_seconds", uptime)
        if rss is not None:
            STATE.registry.set("sbt_process_rss_bytes", float(rss))
        # device residency twins: honest-None on backends
        # without memory stats (CPU) — the gauges simply don't exist
        # there, they never report a made-up 0
        from spark_bagging_tpu_torch.utils.memory import device_memory_stats

        for d in device_memory_stats() or ():
            labels = {"device": str(d["id"])}
            STATE.registry.set("sbt_process_device_bytes_in_use",
                               float(d["bytes_in_use"]), labels)
            STATE.registry.set("sbt_process_device_bytes_limit",
                               float(d["bytes_limit"]), labels)
            if d["peak_bytes_in_use"] is not None:
                STATE.registry.set("sbt_process_device_peak_bytes",
                                   float(d["peak_bytes_in_use"]),
                                   labels)
        # capacity gauge refresh: scrape-time, like rss — the alert
        # rules (default_capacity_rules) read headroom/cold-resident
        # off the registry, so each scrape re-derives them
        from spark_bagging_tpu_torch.telemetry import capacity

        plane = capacity.ACTIVE
        if plane is not None:
            plane.export_gauges()
    return uptime, rss


def _varz() -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import recorder
    from spark_bagging_tpu_torch.telemetry.state import STATE

    uptime, rss = _refresh_process_gauges()
    out = {
        "ts": time.time(),
        "pid": os.getpid(),
        "uptime_seconds": uptime,
        "rss_bytes": rss,
        "telemetry_enabled": STATE.enabled,
        "health": health_report(),
        "metrics": STATE.registry.snapshot(quantiles=True),
    }
    rec = recorder.get()
    if rec is not None:
        # the peer-side incident feed: dump records + ring trigger
        # events — what a fleet aggregator's /fleet/incidents
        # correlation consumes from this process's scrape
        out["flight"] = {"armed": rec.armed, **rec.timeline_feed()}
    return out


def _debug_spans(query: dict[str, list[str]]) -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import recorder

    rec = recorder.get()
    if rec is None:
        return {"spans": [], "note": "flight recorder not armed"}
    spans = rec.events(kind="span")
    trace_id = (query.get("trace_id") or [None])[0]
    if trace_id:
        spans = [
            s for s in spans
            if s.get("trace_id") == trace_id
            or trace_id in (s.get("links") or ())
        ]
    try:
        limit = max(0, int((query.get("limit") or ["256"])[0]))
    except ValueError:
        # garbage ?limit= falls back to the default window rather than
        # 500ing the scrape (negative values are clamped above — a raw
        # spans[-limit:] would have INVERTED the slice and returned
        # nearly the whole ring)
        limit = 256
    # limit=0 must mean "none", but spans[-0:] slices from the START
    # and would return the whole ring
    return {"spans": spans[-limit:] if limit else []}


def _debug_workload() -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import workload

    rec = workload.active()
    if rec is None:
        return {
            "recording": False,
            "note": "no workload recorder active; start one with "
                    "telemetry.workload.record()",
        }
    return rec.summary()


def _debug_drift() -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import quality

    return quality.debug_summary()


def _debug_history(query: dict[str, list[str]]) -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import history

    try:
        limit = max(0, int((query.get("limit") or ["32"])[0]))
    except ValueError:
        limit = 32
    return history.history_report(limit=limit)


def _debug_tail(query: dict[str, list[str]]) -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import perf

    try:
        limit = max(1, int((query.get("limit") or ["8"])[0]))
    except ValueError:
        limit = 8
    try:
        window_s = float((query.get("window_s") or ["1.0"])[0])
    except ValueError:
        window_s = 1.0
    tenant = (query.get("tenant") or [None])[0]
    return perf.tail_report(limit=limit, window_s=window_s,
                            tenant=tenant)


def _debug_capacity(query: dict[str, list[str]]) -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import capacity

    try:
        limit = max(1, int((query.get("limit") or ["64"])[0]))
    except ValueError:
        limit = 64
    return capacity.capacity_report(limit=limit)


def _debug_tenancy() -> dict[str, Any]:
    """The installed :class:`~spark_bagging_tpu_torch.tenancy.fleet.
    TenantFleet`'s full policy report — admission state machine, WFQ
    audit, residency transcript counts, refit budget, quarantine
    machine state. An honest explicit shape when no fleet is installed
    (a single-model process is the common case, not an error)."""
    from spark_bagging_tpu_torch import tenancy

    fleet = tenancy.get()
    if fleet is None:
        return {"enabled": False,
                "note": "no TenantFleet installed (tenancy.install)"}
    fleet.export_gauges()
    return {"enabled": True, **fleet.report()}


def _debug_profile(query: dict[str, list[str]]) -> tuple[int, dict]:
    """On-demand live device profiling: ``?seconds=N`` starts a
    torch.profiler capture that auto-stops after N seconds (clamped to
    the hard maximum) into ``telemetry_dir()/profiles/``, where it
    writes a Chrome trace (``trace.json``); a second
    request while one runs is rejected with 409 (the single-flight
    guard shared with ``utils.profiling.trace()``); ``?action=stop``
    ends a capture early."""
    from spark_bagging_tpu_torch.utils import profiling

    action = (query.get("action") or ["start"])[0]
    if action == "stop":
        info = profiling.stop_profile()
        if info is None:
            return 200, {"stopped": False,
                         "note": "no capture was running"}
        return 200, {"stopped": True, **info}
    if action != "start":
        return 400, {"error": f"unknown action {action!r} "
                              "(start or stop)"}
    try:
        seconds = float((query.get("seconds") or ["5"])[0])
    except ValueError:
        return 400, {"error": "seconds must be a number"}
    if seconds <= 0:
        return 400, {"error": f"seconds must be > 0, got {seconds}"}
    try:
        info = profiling.start_profile(max_seconds=seconds)
    except profiling.ProfilerBusy as e:
        return 409, {"error": str(e), "active": profiling.profile_active()}
    return 200, {
        "started": True,
        "max_seconds_cap": profiling.PROFILE_MAX_SECONDS,
        "view": ("Perfetto or chrome://tracing: "
                 + os.path.join(str(info["dir"]), "trace.json")),
        **info,
    }


def _alerts() -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import alerts

    eng = alerts.get()
    if eng is None:
        return {
            "rules": [], "active": [],
            "note": "no alert engine installed; install rules with "
                    "telemetry.alerts.install([...])",
        }
    # scrape-driven evaluation: polling /alerts IS the tick loop for
    # deployments that run no evaluator of their own
    eng.evaluate()
    return eng.state()


def _fleet(route: str):
    """Dispatch a ``/fleet/*`` route against the process-default
    aggregator: each scrape ticks it (interval-limited — a tight curl
    loop cannot hammer the peers), then serves the requested merged
    view. ``(status, body, content_type|None)``; JSON when None."""
    from spark_bagging_tpu_torch.telemetry import fleet
    from spark_bagging_tpu_torch.telemetry.registry import render_prometheus

    agg = fleet.get()
    if agg is None:
        return 404, {
            "error": "no fleet aggregator installed; install one with "
                     "telemetry.fleet.install(FleetAggregator([...]))",
        }, None
    agg.tick()
    if route == "metrics":
        return 200, render_prometheus(agg.merged_snapshot()), \
            "text/plain; version=0.0.4"
    if route == "varz":
        return 200, agg.fleet_varz(), None
    if route == "healthz":
        report = agg.fleet_health()
        return (200 if report["healthy"] else 503), report, None
    if route == "incidents":
        return 200, agg.incident_timeline(), None
    return 404, {"error": f"no route /fleet/{route}"}, None


def _debug_runs() -> dict[str, Any]:
    from spark_bagging_tpu_torch.telemetry import sinks

    active = {r.run_id for r in [sinks.current_run()] if r is not None}
    return {
        "runs": [
            {
                "run_id": r.run_id,
                "label": r.label,
                "path": r.path,
                "t_start": r.t_start,
                "n_events": r.n_events,
                "active": r.run_id in active,
            }
            for r in sinks.runs()
        ]
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "sbt-telemetry/1"

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        url = urlparse(self.path)
        query = parse_qs(url.query)
        try:
            if url.path == "/metrics":
                from spark_bagging_tpu_torch.telemetry.registry import (
                    render_prometheus,
                )
                from spark_bagging_tpu_torch.telemetry.state import STATE

                _refresh_process_gauges()
                body = render_prometheus(STATE.registry.snapshot())
                self._send(200, body, "text/plain; version=0.0.4")
            elif url.path == "/healthz":
                report = health_report()
                self._send_json(200 if report["healthy"] else 503, report)
            elif url.path == "/varz":
                self._send_json(200, _varz())
            elif url.path == "/debug/spans":
                self._send_json(200, _debug_spans(query))
            elif url.path == "/debug/runs":
                self._send_json(200, _debug_runs())
            elif url.path == "/debug/workload":
                self._send_json(200, _debug_workload())
            elif url.path == "/alerts":
                self._send_json(200, _alerts())
            elif url.path == "/debug/drift":
                self._send_json(200, _debug_drift())
            elif url.path == "/debug/tail":
                self._send_json(200, _debug_tail(query))
            elif url.path == "/debug/history":
                self._send_json(200, _debug_history(query))
            elif url.path == "/debug/capacity":
                self._send_json(200, _debug_capacity(query))
            elif url.path == "/debug/tenancy":
                self._send_json(200, _debug_tenancy())
            elif url.path == "/debug/profile":
                code, body = _debug_profile(query)
                self._send_json(code, body)
            elif url.path.startswith("/fleet/"):
                code, body, ctype = _fleet(url.path[len("/fleet/"):])
                if ctype is not None:
                    self._send(code, body, ctype)
                else:
                    self._send_json(code, body)
            elif url.path == "/":
                self._send_json(200, {
                    "endpoints": [
                        "/metrics", "/healthz", "/varz", "/alerts",
                        "/debug/spans", "/debug/runs",
                        "/debug/workload", "/debug/drift",
                        "/debug/tail", "/debug/history",
                        "/debug/capacity", "/debug/tenancy",
                        "/debug/profile",
                        "/fleet/metrics", "/fleet/varz",
                        "/fleet/healthz", "/fleet/incidents",
                    ],
                })
            else:
                self._send_json(404, {"error": f"no route {url.path}"})
        except (BrokenPipeError, ConnectionResetError):
            # the client hung up mid-response (scrape timeout, Ctrl-C'd
            # curl) — there is nothing to report and no socket left to
            # report it on; writing a 500 here would raise again and
            # spam handle_error tracebacks on every aborted scrape
            pass
        # sbt-lint: disable=swallowed-fault — surfaced to the scraper as a 500 body carrying the error
        except Exception as e:  # noqa: BLE001 — the instrument panel
            # must report its own faults, not close the connection
            try:
                self._send_json(500, {"error": repr(e)})
            except OSError:
                pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, obj: dict) -> None:
        self._send(code, json.dumps(obj, default=str),
                   "application/json")

    def log_message(self, format: str, *args: Any) -> None:
        """Silence per-request stderr lines — scrapes every few seconds
        would otherwise drown the process's real logging."""


def start_server(
    port: int | None = None, host: str = "127.0.0.1",
) -> int:
    """Start the exposition server on a daemon thread; returns the
    bound port (useful with ``port=0``). Idempotent while running —
    a second call returns the live server's port. ``port=None`` reads
    ``SBT_METRICS_PORT``. Arms the default flight recorder so
    ``/debug/spans`` has an event window to serve."""
    global _server, _thread, _t_start
    from spark_bagging_tpu_torch.telemetry import recorder

    with _module_lock:
        if _server is not None:
            return _server.server_address[1]
        if port is None:
            env = os.environ.get("SBT_METRICS_PORT", "")
            if not env:
                raise ValueError(
                    "no port given and SBT_METRICS_PORT is not set"
                )
            port = int(env)
        srv = ThreadingHTTPServer((host, int(port)), _Handler)
        srv.daemon_threads = True
        thread = threading.Thread(
            target=srv.serve_forever, kwargs={"poll_interval": 0.25},
            daemon=True, name="sbt-telemetry-server",
        )
        # start INSIDE the lock: a concurrent stop_server() that saw
        # the published globals would otherwise call srv.shutdown(),
        # which blocks forever unless serve_forever() is already
        # running (socketserver's __is_shut_down handshake)
        thread.start()
        _server, _thread, _t_start = srv, thread, time.monotonic()
    recorder.arm()
    return srv.server_address[1]


def stop_server() -> None:
    """Shut the server down and join its thread (idempotent). Leaves
    the flight recorder armed — failures after the scrape endpoint
    goes away are exactly the ones worth recording."""
    global _server, _thread, _t_start
    with _module_lock:
        srv, thread = _server, _thread
        _server = _thread = _t_start = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if thread is not None:
        thread.join(5.0)


def server_address() -> tuple[str, int] | None:
    """``(host, port)`` while running, else None."""
    with _module_lock:
        if _server is None:
            return None
        addr = _server.server_address
        return (str(addr[0]), int(addr[1]))


def maybe_start_from_env() -> int | None:
    """Start iff ``SBT_METRICS_PORT`` is set (the package calls this at
    import, making ``SBT_METRICS_PORT=9100 python serve.py`` the whole
    opt-in story). Never raises — a bad port or an occupied socket
    must not take down the workload it observes."""
    if not os.environ.get("SBT_METRICS_PORT", ""):
        return None
    try:
        return start_server()
    except Exception as e:  # noqa: BLE001 — observability is optional
        import warnings

        warnings.warn(
            f"SBT_METRICS_PORT is set but the telemetry server failed "
            f"to start: {e!r}",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
