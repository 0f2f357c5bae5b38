"""Declarative alert engine over the live metrics registry.

Drift gauges (``sbt_quality_*``), serving counters (``sbt_serving_*``)
and every other registry series become *actionable* here: an
:class:`AlertRule` names a series, a threshold, and a multi-window
burn-rate pair, and the :class:`AlertEngine` turns breaches into
``alert_fired`` / ``alert_resolved`` events — which the flight
recorder treats as triggers, so an alert arrives with the black box of
what was happening when it fired.

**Rule grammar** (``AlertRule.from_dict``; JSON-friendly)::

    {"name":        "feature-drift",
     "series":      "sbt_quality_psi_max",     # registry series name
     "labels":      null,                      # optional label match
     "kind":        "value",                   # "value" (gauge) |
                                               # "rate" (counter /s)
     "op":          ">",                       # ">" | "<"
     "threshold":   0.5,
     "fast_window_s": 30.0,                    # both windows must
     "slow_window_s": 300.0,                   # breach to fire
     "cooldown_s":  300.0,                     # min gap between fires
     "severity":    "page",
     "description": "live traffic no longer matches training"}

**Multi-window burn rate** (the SRE-workbook shape): the condition
must hold over BOTH the fast and the slow window — the fast window
catches the incident quickly, the slow window keeps a transient blip
from paging. ``kind="rate"`` evaluates a counter's per-second rate
over each window; ``kind="value"`` requires every sample in the
window to breach. Either way a window only counts once the engine has
watched at least that long (no alert from one lucky sample at
startup).

**Evaluation is pull-based and clock-injectable**: nothing runs per
request — call :meth:`AlertEngine.evaluate` from a scrape, a loop,
or a replay harness. ``now`` is injectable: an engine driven on a
virtual clock gives byte-identical alert behavior run after run.

**Lifecycle**: fire emits one ``alert_fired`` event (flight-recorder
trigger), bumps ``sbt_alerts_fired_total{rule=...}``, and marks the
rule active; while active it cannot re-fire (one incident, one
alert). It resolves — ``alert_resolved``, counted — when the latest
sample stops breaching, and a re-fire within ``cooldown_s`` of the
last fire is suppressed (counted in
``sbt_alerts_suppressed_total``), so a flapping series cannot page
once per flap.

The port's copy of the JAX package's ``telemetry/alerts.py``.
:func:`default_capacity_rules` reads the capacity plane's gauges
(``telemetry/capacity.py``, refreshed on every scrape); its tenancy
rules read the series the tenancy plane exports (``tenancy/fleet.py``,
``tenancy/admission.py``, ``tenancy/residency.py``) — without a fleet
those series are absent and the rules never fire.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.telemetry.state import STATE


def _emit(event: dict) -> None:
    """Deliver an event to the process sinks (the facade's emit_event
    without the facade import — this module is imported BY it)."""
    if STATE.enabled and STATE._sinks:
        event.setdefault("ts", time.time())
        STATE.emit(event)


class AlertRule:
    """One declarative condition over a registry series (see module
    docstring for the grammar)."""

    KINDS = ("value", "rate")
    OPS = (">", "<")
    FIELDS = (
        "name", "series", "labels", "kind", "op", "threshold",
        "fast_window_s", "slow_window_s", "cooldown_s", "severity",
        "description",
    )

    def __init__(
        self,
        name: str,
        series: str,
        *,
        threshold: float,
        labels: dict[str, Any] | None = None,
        kind: str = "value",
        op: str = ">",
        fast_window_s: float = 30.0,
        slow_window_s: float = 300.0,
        cooldown_s: float = 300.0,
        severity: str = "page",
        description: str = "",
    ) -> None:
        if kind not in self.KINDS:
            raise ValueError(
                f"rule {name!r}: kind must be one of {self.KINDS}, "
                f"got {kind!r}"
            )
        if op not in self.OPS:
            raise ValueError(
                f"rule {name!r}: op must be one of {self.OPS}, got {op!r}"
            )
        if not (0 < fast_window_s <= slow_window_s):
            raise ValueError(
                f"rule {name!r}: need 0 < fast_window_s <= "
                f"slow_window_s, got {fast_window_s}, {slow_window_s}"
            )
        if cooldown_s < 0:
            raise ValueError(
                f"rule {name!r}: cooldown_s must be >= 0, got "
                f"{cooldown_s}"
            )
        self.name = str(name)
        self.series = str(series)
        self.labels = dict(labels) if labels else None
        self.kind = kind
        self.op = op
        self.threshold = float(threshold)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.cooldown_s = float(cooldown_s)
        self.severity = str(severity)
        self.description = str(description)

    def breaches(self, v: float) -> bool:
        return v > self.threshold if self.op == ">" else v < self.threshold

    def to_dict(self) -> dict[str, Any]:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AlertRule":
        unknown = set(d) - set(cls.FIELDS)
        if unknown:
            raise ValueError(
                f"unknown alert rule fields {sorted(unknown)}; have "
                f"{list(cls.FIELDS)}"
            )
        if "name" not in d or "series" not in d or "threshold" not in d:
            raise ValueError(
                "an alert rule needs at least name, series, threshold"
            )
        kw = dict(d)
        name = kw.pop("name")
        series = kw.pop("series")
        return cls(name, series, **kw)

    def __repr__(self) -> str:
        return (f"AlertRule({self.name!r}, {self.series!r} {self.op} "
                f"{self.threshold}, windows=({self.fast_window_s}, "
                f"{self.slow_window_s})s)")


class _RuleState:
    __slots__ = ("rule", "samples", "t_first", "active", "last_fired",
                 "fired", "resolved", "suppressed", "last_value",
                 "last_eval")

    def __init__(self, rule: AlertRule) -> None:
        self.rule = rule
        # (t, value) samples; pruned to the slow window plus one older
        # sample (the rate anchor / coverage witness)
        self.samples: deque[tuple[float, float]] = deque()
        self.t_first: float | None = None
        self.active = False
        self.last_fired: float | None = None
        self.fired = 0
        self.resolved = 0
        self.suppressed = 0
        self.last_value: float | None = None
        self.last_eval: float | None = None


# sbt-lint: shared-state
class AlertEngine:
    """Evaluate a rule set against the live registry; emit events.

    Construct with rules (or :meth:`add_rule` later) and call
    :meth:`evaluate` on whatever cadence suits — scrape handlers,
    a periodic loop, or a replay's virtual clock via ``now=``. The
    engine holds no thread of its own: deterministic by construction.
    """

    def __init__(self, rules=(), *, registry=None) -> None:
        self._lock = make_lock("telemetry.alerts")
        self._states: dict[str, _RuleState] = {}
        # direct listeners (subscribe()): the trigger-bus seam — the
        # online trainer hangs its refit trigger here. Delivered after
        # the engine lock is released, alongside the sink emits
        self._listeners: list[Any] = []
        # where rule series are sampled from: anything with a
        # ``peek(name, labels)`` returning an object carrying
        # ``kind``/``value`` (the process Registry, or a merged-series
        # view of several processes). None = the process-wide
        # registry, read at evaluate time.
        self._registry = registry
        for r in rules:
            self.add_rule(r)

    def add_rule(self, rule: AlertRule | dict) -> AlertRule:
        if isinstance(rule, dict):
            rule = AlertRule.from_dict(rule)
        with self._lock:
            if rule.name in self._states:
                raise ValueError(
                    f"alert rule {rule.name!r} already installed"
                )
            self._states[rule.name] = _RuleState(rule)
        return rule

    def rules(self) -> tuple[AlertRule, ...]:
        with self._lock:
            return tuple(st.rule for st in self._states.values())

    # -- the trigger bus -----------------------------------------------

    def subscribe(self, listener) -> None:
        """Register a callable receiving every ``alert_fired`` /
        ``alert_resolved`` event this engine emits — the trigger-bus
        seam the online trainer (``online/trainer.py``) subscribes
        its refit trigger to. Listeners run AFTER the engine lock is
        released (a listener may re-enter the engine — ``state()``
        from a trainer transcript is fine) and exceptions are
        isolated: one broken consumer must not unhook alerting for
        everyone else (warned, not raised)."""
        if not callable(listener):
            raise TypeError(f"listener must be callable, got "
                            f"{type(listener).__name__}")
        with self._lock:
            if listener not in self._listeners:
                self._listeners.append(listener)

    def unsubscribe(self, listener) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def _notify(self, events: list[dict]) -> None:
        if not events:
            return
        with self._lock:
            listeners = list(self._listeners)
        for ev in events:
            for fn in listeners:
                try:
                    fn(ev)
                except Exception as e:  # noqa: BLE001 — isolation, see
                    # subscribe(): alert delivery must survive one
                    # broken consumer
                    import warnings

                    warnings.warn(
                        f"alert listener {fn!r} raised {e!r}; event "
                        f"{ev.get('kind')}/{ev.get('rule')} dropped "
                        "for that listener only",
                        RuntimeWarning,
                        stacklevel=2,
                    )

    # -- sampling ------------------------------------------------------

    def _read_series(self, rule: AlertRule) -> float | None:
        """Current value of the rule's series, or None when there is
        nothing to sample: the series was never written (absent data
        is 'no evidence' — it must NOT read as 0.0, or an ``op "<"``
        rule would page on a service that served no traffic), or it
        exists under the wrong metric kind for the rule (a value rule
        aimed at a histogram must not poison the whole pass)."""
        reg = self._registry if self._registry is not None \
            else STATE.registry
        metric = reg.peek(rule.series, rule.labels)
        if metric is None:
            return None
        want = "counter" if rule.kind == "rate" else "gauge"
        if metric.kind != want:
            return None
        return float(metric.value)

    @staticmethod
    def _breach_value(st: _RuleState, now: float, window: float) -> bool:
        """Every sample in the window breaches, and the engine has
        watched at least that long."""
        if st.t_first is None or now - st.t_first < window:
            return False
        seen = False
        for t, v in reversed(st.samples):
            if t < now - window:
                break
            seen = True
            if not st.rule.breaches(v):
                return False
        return seen

    @staticmethod
    def _breach_rate(st: _RuleState, now: float, window: float) -> bool:
        """The counter's per-second rate over the window breaches.
        Anchored at the latest sample at or before the window start —
        absent one, there is no honest rate yet."""
        anchor: tuple[float, float] | None = None
        for t, v in st.samples:
            if t <= now - window:
                anchor = (t, v)
            else:
                break
        if anchor is None or not st.samples:
            return False
        t_now, v_now = st.samples[-1]
        dt = t_now - anchor[0]
        if dt <= 0:
            return False
        return st.rule.breaches((v_now - anchor[1]) / dt)

    # -- the tick ------------------------------------------------------

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One evaluation pass over every rule; returns the events
        emitted (``alert_fired`` / ``alert_resolved``). ``now``
        defaults to the monotonic clock; inject a virtual clock for
        deterministic replay."""
        if now is None:
            now = time.monotonic()
        events: list[dict] = []
        counters: list[tuple[str, dict | None]] = []
        with self._lock:
            for st in self._states.values():
                rule = st.rule
                v = self._read_series(rule)
                st.last_value = v
                st.last_eval = now
                if v is None:
                    continue  # kind-mismatched series: no sample
                if st.t_first is None:
                    st.t_first = now
                st.samples.append((now, v))
                # prune: keep the slow window plus ONE older sample
                # (rate anchor); bounded regardless of tick cadence
                cutoff = now - rule.slow_window_s
                while (len(st.samples) >= 2
                       and st.samples[1][0] <= cutoff):
                    st.samples.popleft()
                breach_fn = (self._breach_rate if rule.kind == "rate"
                             else self._breach_value)
                breach = (breach_fn(st, now, rule.fast_window_s)
                          and breach_fn(st, now, rule.slow_window_s))
                if breach and not st.active:
                    if (st.last_fired is not None
                            and now - st.last_fired < rule.cooldown_s):
                        st.suppressed += 1
                        counters.append((
                            "sbt_alerts_suppressed_total",
                            {"rule": rule.name},
                        ))
                    else:
                        st.active = True
                        st.last_fired = now
                        st.fired += 1
                        counters.append((
                            "sbt_alerts_fired_total",
                            {"rule": rule.name},
                        ))
                        # stamped HERE, not in the emit path: consumers
                        # that hold the event itself (the fleet
                        # aggregator's incident log) need the wall
                        # clock even when no sink is subscribed
                        events.append({
                            "kind": "alert_fired",
                            "ts": time.time(),
                            "rule": rule.name,
                            "series": rule.series,
                            "value": v,
                            "threshold": rule.threshold,
                            "op": rule.op,
                            "severity": rule.severity,
                            "windows_s": [rule.fast_window_s,
                                          rule.slow_window_s],
                            "description": rule.description,
                            "now": now,
                        })
                elif st.active and not (
                    self._breach_rate(st, now, rule.fast_window_s)
                    if rule.kind == "rate" else rule.breaches(v)
                ):
                    # the incident is over. Value rules resolve on a
                    # clean LATEST sample; rate rules must re-evaluate
                    # the windowed rate — the raw cumulative counter
                    # value never falls back under a per-second
                    # threshold, so comparing it directly would leave
                    # the alert active forever after one burst (and an
                    # active rule cannot re-fire, swallowing every
                    # later genuine incident)
                    st.active = False
                    st.resolved += 1
                    counters.append((
                        "sbt_alerts_resolved_total",
                        {"rule": rule.name},
                    ))
                    events.append({
                        "kind": "alert_resolved",
                        "ts": time.time(),
                        "rule": rule.name,
                        "series": rule.series,
                        "value": v,
                        "severity": rule.severity,
                        "now": now,
                    })
            n_active = sum(1 for st in self._states.values()
                           if st.active)
        if STATE.enabled:
            reg = STATE.registry
            reg.inc("sbt_alerts_evaluations_total")
            reg.set("sbt_alerts_active", float(n_active))
            for name, labels in counters:
                reg.inc(name, 1.0, labels)
        # emit AFTER releasing the engine lock: an alert_fired event
        # triggers the flight recorder, whose dump snapshots the
        # registry and writes a file — none of that belongs under the
        # lock the next evaluate() needs
        for ev in events:
            _emit(ev)
        self._notify(events)
        return events

    # -- introspection -------------------------------------------------

    def active(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(
                name for name, st in self._states.items() if st.active
            ))

    def state(self) -> dict[str, Any]:
        """JSON digest for ``/alerts``."""
        with self._lock:
            rules = []
            for st in self._states.values():
                rules.append({
                    **st.rule.to_dict(),
                    "active": st.active,
                    "fired": st.fired,
                    "resolved": st.resolved,
                    "suppressed": st.suppressed,
                    "last_value": st.last_value,
                    "last_eval": st.last_eval,
                    "last_fired": st.last_fired,
                })
            return {
                "rules": rules,
                "active": sorted(
                    name for name, st in self._states.items()
                    if st.active
                ),
            }


def default_drift_rules(
    *,
    psi_threshold: float = 0.5,
    confidence_psi_threshold: float = 0.5,
    fast_window_s: float = 30.0,
    slow_window_s: float = 300.0,
    cooldown_s: float = 300.0,
    labels: dict[str, Any] | None = None,
    name_prefix: str = "",
) -> list[AlertRule]:
    """The starter rule set for the quality plane: feature drift
    (``sbt_quality_psi_max``) and prediction-confidence drift
    (``sbt_quality_confidence_psi``). ``labels`` must match the
    monitor's gauge labels — ``{"model": name}`` for a monitor
    attached via ``ModelRegistry.enable_quality(name)`` (its
    ``monitor.labels``), omitted for an anonymous executor's monitor.
    ``name_prefix`` disambiguates rule names when installing the set
    once per model."""
    return [
        AlertRule(
            f"{name_prefix}feature-drift", "sbt_quality_psi_max",
            labels=labels,
            threshold=psi_threshold, kind="value", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="live feature distribution no longer matches "
                        "the training reference (max per-feature PSI)",
        ),
        AlertRule(
            f"{name_prefix}confidence-drift",
            "sbt_quality_confidence_psi", labels=labels,
            threshold=confidence_psi_threshold, kind="value", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="served confidence distribution no longer "
                        "matches the OOB reference",
        ),
    ]


def default_capacity_rules(
    *,
    headroom_threshold: float = 0.1,
    eviction_rate_threshold: float = 1.0,
    tail_p99_threshold_ms: float = 250.0,
    quota_shed_rate_threshold: float = 1.0,
    fast_window_s: float = 30.0,
    slow_window_s: float = 300.0,
    cooldown_s: float = 300.0,
    labels: dict[str, Any] | None = None,
    name_prefix: str = "",
    tenancy: bool = True,
) -> list[AlertRule]:
    """The starter rule set for the capacity plane, reading
    the gauges ``telemetry.capacity`` refreshes on every scrape:

    - **capacity-headroom-low** — the program cache's free-slot ratio
      fell below ``headroom_threshold``: the next cold model admission
      evicts someone;
    - **capacity-cold-model-resident** — entries owned by cold-class
      models are resident while headroom is being consumed — the
      reclaim candidates a residency policy would take first;
    - **capacity-eviction-churn** — sustained eviction burn rate above
      ``eviction_rate_threshold``/s: the cache capacity sits below the
      working set and compiles are being re-paid (the thrash signal
      the ``cache-churn`` drill manufactures deliberately).

    With ``tenancy=True`` (default) the tenant-aware variants
    ride along, reading the series the tenancy plane
    exports (absent series never fire — a process with no fleet pays
    nothing for carrying the rules):

    - **tenancy-tail-latency-burn** — the tail tenants' p99
      (``sbt_tenancy_tail_p99_ms``, everyone but the Zipf head) burned
      above ``tail_p99_threshold_ms`` across both windows: the fleet
      is serving its head at the tail's expense;
    - **tenancy-quota-shed-rate** — sustained admission sheds above
      ``quota_shed_rate_threshold``/s: quotas/priorities are actively
      rejecting traffic, not just backstopping a burst;
    - **tenancy-pin-violation** — a residency/cache eviction had to
      sacrifice a hot-pinned tenant: the residency budget (or cache
      capacity) is smaller than the hot set;
    - **tenancy-quarantine-flapping** — two or more quarantine trips
      (``sbt_tenant_quarantine_trips_total``) inside the fast window:
      a tenant is cycling trip → probe → re-trip instead
      of recovering, so its backoff ladder (or the underlying fault)
      needs an operator.
    """
    tenancy_rules = [
        AlertRule(
            f"{name_prefix}tenancy-tail-latency-burn",
            "sbt_tenancy_tail_p99_ms", labels=labels,
            threshold=tail_p99_threshold_ms, kind="value", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="tail-tenant p99 latency burning above "
                        "threshold: the fleet serves its head at the "
                        "tail's expense",
        ),
        AlertRule(
            f"{name_prefix}tenancy-quota-shed-rate",
            "sbt_tenancy_shed_total", labels=labels,
            threshold=quota_shed_rate_threshold, kind="rate", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="sustained admission shed rate: quotas/"
                        "priorities rejecting steady traffic, not a "
                        "burst",
        ),
        AlertRule(
            f"{name_prefix}tenancy-pin-violation",
            "sbt_tenancy_pin_violations_total", labels=labels,
            threshold=0.0, kind="rate", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="hot-pinned tenants being evicted: the "
                        "residency budget is smaller than the hot set",
        ),
        AlertRule(
            f"{name_prefix}tenancy-quarantine-flapping",
            "sbt_tenant_quarantine_trips_total", labels=labels,
            # ≥2 trips inside the fast window, expressed as the burn
            # rate the engine evaluates (strictly above 1.5 trips per
            # fast window tolerates no flapping but ignores a single
            # contained trip-and-recover)
            threshold=1.5 / fast_window_s, kind="rate", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="quarantine flapping: a tenant is cycling "
                        "trip/probe/re-trip instead of recovering",
        ),
    ] if tenancy else []
    return [
        AlertRule(
            f"{name_prefix}capacity-headroom-low",
            "sbt_capacity_cache_headroom_ratio", labels=labels,
            threshold=headroom_threshold, kind="value", op="<",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="program-cache free-slot ratio below "
                        "threshold: the next admission evicts",
        ),
        AlertRule(
            f"{name_prefix}capacity-cold-model-resident",
            "sbt_capacity_cold_resident_entries", labels=labels,
            threshold=0.0, kind="value", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="cold-demand models hold resident cache "
                        "entries — reclaimable bytes",
        ),
        AlertRule(
            f"{name_prefix}capacity-eviction-churn",
            "sbt_program_cache_evictions_total", labels=labels,
            threshold=eviction_rate_threshold, kind="rate", op=">",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            cooldown_s=cooldown_s,
            description="sustained program-cache eviction burn rate: "
                        "capacity below the working set, compiles "
                        "being re-paid",
        ),
    ] + tenancy_rules


# -- process default ----------------------------------------------------

_default: AlertEngine | None = None
# concurrent first installs must not each build an engine — the loser
# would evaluate a detached rule set nobody can see on /alerts
_default_lock = make_lock("telemetry.alerts.default")


def install(rules=()) -> AlertEngine:
    """Install rules on the process-default engine (created on first
    call) — what ``/alerts`` serves and evaluates on every scrape."""
    global _default
    with _default_lock:
        if _default is None:
            _default = AlertEngine()
        eng = _default
    for r in rules:
        eng.add_rule(r)
    return eng


def get() -> AlertEngine | None:
    """The process-default engine, if one was ever installed."""
    return _default


def uninstall() -> None:
    """Drop the process-default engine (test isolation; embedders
    rebuilding their rule set)."""
    global _default
    with _default_lock:
        _default = None
