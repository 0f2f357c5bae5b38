"""Failure flight recorder — a post-mortem artifact for serving faults.

Metrics say *that* something went wrong; the flight recorder preserves
*what was happening when it did*. Armed, it subscribes to the process
event stream (every span, fit report, and serving fault event) into a
bounded ring buffer, and on a trigger event atomically writes
``flight_<ts>_<seq>.json`` into the telemetry dir containing:

- the trigger event itself (with its ``trace_id``/``links``, so the
  failing request is resolvable in the captured window);
- the last ``capacity`` events (the ring — enqueue/batch/forward/
  scatter spans of the traffic leading up to the fault);
- a full metrics-registry snapshot (queue depth, overload counts,
  latency histograms with quantiles at the moment of failure);
- held-lock state across all threads plus any recorded lock-order
  violations (``analysis.locks`` — populated when ``SBT_LOCK_DEBUG``
  is armed, empty otherwise).

Triggers (event ``kind``):

- ``serving_batch_error`` — an executor forward failed a micro-batch;
- ``swap_rejected`` — a hot-swap failed contract validation;
- ``alert_fired`` — the quality plane's alert engine tripped a rule
  (drift, burn rate — see ``telemetry/alerts.py``);
- ``serving_overloaded`` — only as a BURST: ``burst_threshold``
  rejections inside ``burst_window_s`` (a single shed request is
  backpressure working as designed; a burst is an incident).

A per-kind ``cooldown_s`` guarantees one dump per incident, not one
per failing request (``sbt_flight_dumps_suppressed_total`` counts the
suppressed ones). The ring costs one deque append per event and is
only subscribed while armed — the disabled serving hot path never
sees it.

The port's copy of the JAX package's ``telemetry/recorder.py``; its
dumps carry the same keys, so one post-mortem tool reads both.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any

from spark_bagging_tpu_torch.analysis.locks import make_lock

DUMP_SCHEMA_VERSION = 1

# event kinds that dump immediately (one incident = one event);
# alert_fired is the quality plane's contribution — an alert arrives
# with the black box of the traffic that tripped it; the fault plane
# adds worker crash loops, pre-commit swap failures, and lost
# serving shards (each per-kind cooldown'd to one dump per incident)
TRIGGER_KINDS = ("serving_batch_error", "swap_rejected", "alert_fired",
                 "serving_crash_loop", "swap_failed",
                 "serving_shard_failed", "refit_rejected")
# event kind that dumps only as a burst
BURST_KIND = "serving_overloaded"

# event kinds the fleet incident timeline collects from each peer's
# ring: every dump trigger, the overload bursts, and the swap/refit
# commits (not incidents themselves, but the events incidents
# correlate WITH — "did that flight dump land right after peer 2's
# rolling swap?")
TIMELINE_KINDS = TRIGGER_KINDS + (BURST_KIND, "model_swapped",
                                  "refit_published")


# sbt-lint: shared-state
class FlightRecorder:
    """Bounded event ring + trigger-driven atomic JSON dumps.

    Implements the sink protocol (``emit(event)``) and attaches to the
    process-wide event stream via :meth:`arm`. All knobs are
    constructor arguments; the module-level :func:`arm` manages a
    process default instance.
    """

    def __init__(
        self,
        *,
        capacity: int = 2048,
        dir: str | None = None,
        burst_threshold: int = 10,
        burst_window_s: float = 1.0,
        cooldown_s: float = 30.0,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if burst_threshold < 1:
            # 0 would make the burst check index an empty deque (the
            # deque's maxlen) and raise from inside emit(); "dump on
            # every shed" is burst_threshold=1
            raise ValueError(
                f"burst_threshold must be >= 1, got {burst_threshold}"
            )
        self.capacity = int(capacity)
        self.dir = dir
        self.burst_threshold = int(burst_threshold)
        self.burst_window_s = float(burst_window_s)
        self.cooldown_s = float(cooldown_s)
        self._lock = make_lock("telemetry.recorder")
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._overload_ts: deque[float] = deque(maxlen=self.burst_threshold)
        self._last_dump_ts: dict[str, float] = {}
        self._seq = 0
        self._armed = False
        self.dumps: list[str] = []  # paths written, in order
        # compact per-dump records (path, ts, trigger kind + handle):
        # what a fleet aggregator scrapes to place this peer's dumps on
        # the correlated incident timeline without re-reading the files
        self.dump_records: list[dict] = []

    # -- sink protocol -------------------------------------------------

    def emit(self, event: dict) -> None:
        """Record one event; dump if it is (or completes) a trigger."""
        if event.get("kind") == "serving_request":
            # the per-request arrival stream (workload capture)
            # is the highest-rate event in the process and carries no
            # forensic value the enqueue span doesn't: ringing it
            # would evict the span/error window — the thing a flight
            # dump exists to preserve — in under a second of real
            # traffic. Workload recorders subscribe separately.
            return
        trigger: dict | None = None
        with self._lock:
            self._ring.append(event)
            kind = event.get("kind")
            now = time.monotonic()
            if kind in TRIGGER_KINDS:
                trigger = event if self._pass_cooldown(kind, now) else None
            elif kind == BURST_KIND:
                self._overload_ts.append(now)
                burst = (
                    len(self._overload_ts) >= self.burst_threshold
                    and now - self._overload_ts[0] <= self.burst_window_s
                )
                if burst and self._pass_cooldown(kind, now):
                    trigger = event
        if trigger is not None:
            try:
                self.dump(trigger)
            except Exception as e:  # noqa: BLE001 — a failed black-box
                # write (read-only FS, disk full, bad SBT_TELEMETRY_DIR)
                # must not propagate into the serving threads that
                # emitted the trigger: it would kill the batcher worker
                # or surface to clients in place of Overloaded
                import warnings

                # give back the cooldown window the trigger consumed —
                # otherwise one transient write failure silences every
                # further trigger of this kind for cooldown_s and the
                # incident yields zero artifacts
                with self._lock:
                    self._last_dump_ts.pop(trigger.get("kind"), None)
                warnings.warn(
                    f"flight recorder failed to write a dump: {e!r}",
                    RuntimeWarning,
                    stacklevel=2,
                )

    def _pass_cooldown(self, kind: str, now: float) -> bool:
        """Under the ALREADY-HELD lock: one dump per incident window."""
        last = self._last_dump_ts.get(kind)
        if last is not None and now - last < self.cooldown_s:
            from spark_bagging_tpu_torch.telemetry.state import STATE

            if STATE.enabled:
                STATE.registry.inc("sbt_flight_dumps_suppressed_total")
            return False
        # sbt-lint: disable=shared-state-unlocked — every caller holds self._lock (the _pass_cooldown contract)
        self._last_dump_ts[kind] = now
        return True

    # -- introspection -------------------------------------------------

    def events(self, kind: str | None = None, limit: int | None = None):
        """Snapshot of the ring (oldest first), optionally filtered by
        event kind and truncated to the most recent ``limit``."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        if limit is not None:
            out = out[-limit:]
        return out

    # -- the dump ------------------------------------------------------

    def dump(self, trigger: dict | None = None) -> str:
        """Atomically write the black box to ``flight_<ts>_<seq>.json``
        (write-then-rename: a scraper or operator never sees a torn
        file) and return its path. Callable manually for an on-demand
        snapshot; normally driven by :meth:`emit` triggers."""
        from spark_bagging_tpu_torch.analysis import locks
        from spark_bagging_tpu_torch.telemetry.sinks import telemetry_dir
        from spark_bagging_tpu_torch.telemetry.state import STATE

        with self._lock:
            events = list(self._ring)
            self._seq += 1
            seq = self._seq
        payload: dict[str, Any] = {
            "schema": DUMP_SCHEMA_VERSION,
            "ts": time.time(),
            "pid": os.getpid(),
            "trigger": trigger,
            "n_events": len(events),
            "events": events,
            "metrics": STATE.registry.snapshot(quantiles=True),
            "locks": {
                "held": {
                    t: list(names)
                    for t, names in locks.all_held_locks().items()
                },
                "violations": locks.violations(),
                "edges": [list(e) for e in locks.acquisition_edges()],
            },
        }
        base = self.dir or telemetry_dir()
        os.makedirs(base, exist_ok=True)
        path = os.path.join(
            base, f"flight_{int(payload['ts'] * 1000)}_{seq}.json"
        )
        tmp = path + ".tmp"
        # synchronous by design: the black box must be on disk before
        # the triggering thread moves on (a crashing process cannot be
        # asked to finish a background write). No fsync — it would
        # charge a loaded host's full disk queue to the batcher worker
        # or an overloaded client's submit(); rename-visibility and
        # surviving a PROCESS crash need only the page cache
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        record = {
            "path": path,
            "ts": payload["ts"],
            "seq": seq,
            "kind": (trigger or {}).get("kind") or "manual",
        }
        # the trigger's correlation handle, when it carries one: the
        # alert rule, the model a swap died on, the failing trace
        for key in ("rule", "model", "trace_id"):
            v = (trigger or {}).get(key)
            if v is not None:
                record[key] = v
        with self._lock:
            self.dumps.append(path)
            self.dump_records.append(record)
        if STATE.enabled:
            STATE.registry.inc("sbt_flight_dumps_total")
        return path

    def timeline_feed(self, *, dumps: int = 32,
                      events: int = 64) -> dict[str, list[dict]]:
        """The peer-side incident feed: the most recent dump records
        plus the ring's timeline-relevant events (dump triggers,
        overload bursts, swap commits). ``/varz`` exposes it as the
        ``flight`` section, which is what the fleet aggregator's
        ``/fleet/incidents`` correlation consumes."""
        with self._lock:
            recs = list(self.dump_records[-dumps:])
            ring = list(self._ring)
        evs = [e for e in ring if e.get("kind") in TIMELINE_KINDS]
        return {"dumps": recs, "events": evs[-events:]}

    # -- lifecycle -----------------------------------------------------

    def arm(self) -> "FlightRecorder":
        """Subscribe to the process event stream (idempotent)."""
        from spark_bagging_tpu_torch.telemetry.state import STATE

        with self._lock:
            already = self._armed
            self._armed = True
        if not already:
            STATE.add_sink(self)
        return self

    def disarm(self) -> None:
        from spark_bagging_tpu_torch.telemetry.state import STATE

        with self._lock:
            was = self._armed
            self._armed = False
        if was:
            STATE.remove_sink(self)

    @property
    def armed(self) -> bool:
        return self._armed


_default: FlightRecorder | None = None
# guards _default creation: concurrent first arms (a thread calling
# arm() while start_server() arms on another) must not each construct
# and subscribe a recorder — the loser would be an undetachable sink
# writing duplicate dumps
_default_lock = make_lock("telemetry.recorder.default")


def arm(**kwargs: Any) -> FlightRecorder:
    """Arm the process-default recorder (creating it on first call;
    ``kwargs`` are :class:`FlightRecorder` options and only apply at
    creation). The exposition server calls this on start — so under
    ``SBT_METRICS_PORT`` the default recorder already exists with
    default knobs, and a later ``arm(cooldown_s=...)`` cannot retune
    it; that case warns instead of silently dropping the options."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder(**kwargs)
        elif kwargs:
            import warnings

            warnings.warn(
                "flight recorder is already created; arm() options "
                f"{sorted(kwargs)} are ignored (construct "
                "FlightRecorder directly, or disarm and drop the "
                "default first)",
                RuntimeWarning,
                stacklevel=2,
            )
        rec = _default
    return rec.arm()


def disarm() -> None:
    """Detach the process-default recorder from the event stream."""
    if _default is not None:
        _default.disarm()


def get() -> FlightRecorder | None:
    """The process-default recorder, if one was ever armed."""
    return _default
