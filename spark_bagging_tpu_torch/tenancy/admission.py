"""Priority admission control: quotas + overload shedding, per tenant.

The serving edge already HAS backpressure — ``MicroBatcher.submit``
raises ``Overloaded`` when its queue is full and ``Degraded`` in
crash-loop reject mode — but those signals are tenant-blind: under
fleet overload the requests that happen to arrive at the full queue
are the ones shed, regardless of whose they are. The admission
controller turns that backpressure into POLICY:

- **Quotas always bind.** Each tenant's ``quota_rps`` /
  ``quota_rows_ps`` is a deterministic token bucket on the injected
  clock: tokens refill linearly with elapsed time (one-second burst
  capacity), a request that finds the bucket empty is shed with
  reason ``"quota"``. No wall clock is ever read — the caller passes
  ``now`` (the replay drill passes its virtual workload clock), so
  the shed set is a pure function of (workload, specs).

- **Pressure sheds by class.** The state machine is
  ``normal → shed-batch → shed-standard``: the first observed
  ``Overloaded`` within the window moves to shed-batch (every
  ``"batch"``-class request shed with reason ``"priority"``);
  ``escalate_after`` overloads within the same window escalate to
  shed-standard (``"standard"`` sheds too). ``"interactive"`` traffic
  is never priority-shed — only its own quota or the batcher's queue
  can reject it. The state decays back to normal once the window
  passes with no new overload: pressure is evidence-driven in both
  directions, exactly like the batcher's direct-dispatch demotion.

Every decision is counted per tenant
(``sbt_tenancy_admitted_total{tenant=}``,
``sbt_tenancy_shed_total{tenant=,reason=}``) so shed fairness is
auditable, and mirrored into deterministic in-object counters the
replay transcript digests.

The port's copy of the JAX package's ``tenancy/admission.py``.
"""

from __future__ import annotations

from typing import Iterable

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.tenancy.spec import TenantSpec


class AdmissionShed(RuntimeError):
    """A request rejected by admission policy (not by the batcher).

    ``tenant`` and ``reason`` (``"quota"`` | ``"priority"``) identify
    the decision; callers shed at the edge, exactly like
    ``Overloaded``.
    """

    def __init__(self, tenant: str, reason: str, msg: str):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason
        #: the shed request's trace id (stamped by the fleet when
        #: telemetry minted one) — joins the shed against
        #: ``/debug/tail`` and flight dumps
        self.trace_id: str | None = None


class QuotaExceeded(AdmissionShed):
    """The tenant's own token bucket is empty — its problem alone."""

    def __init__(self, tenant: str, msg: str):
        super().__init__(tenant, "quota", msg)


class TenantQuarantined(AdmissionShed):
    """The tenant is quarantined (blast-radius containment): its
    requests are shed at the edge with reason ``"quarantine"`` until
    the seeded backoff elapses and a single probe request recovers it.
    Distinct from quota/priority sheds so clients can tell "slow down"
    from "your tenant is being contained"."""

    def __init__(self, tenant: str, msg: str,
                 trace_id: str | None = None):
        super().__init__(tenant, "quarantine", msg)
        self.trace_id = trace_id


class _Bucket:
    """Deterministic token bucket: linear refill on the passed clock."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst_s: float):
        self.rate = float(rate)
        self.burst = float(rate) * float(burst_s)
        self.tokens = self.burst
        self.last: float | None = None

    def take(self, cost: float, now: float) -> bool:
        if self.last is not None and now > self.last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


# sbt-lint: shared-state
class AdmissionController:
    """Per-tenant quota buckets + the fleet pressure state machine.

    Thread-safe; all time comes from caller-passed ``now`` values so a
    virtual-clock drive is fully deterministic (monotonicity is the
    caller's contract, same as the capacity plane's ``classify``).
    """

    def __init__(
        self,
        specs: Iterable[TenantSpec],
        *,
        pressure_window_s: float = 1.0,
        escalate_after: int = 3,
        burst_s: float = 1.0,
    ) -> None:
        if pressure_window_s <= 0:
            raise ValueError(
                f"pressure_window_s must be > 0, got {pressure_window_s}"
            )
        if escalate_after < 1:
            raise ValueError(
                f"escalate_after must be >= 1, got {escalate_after}"
            )
        self.pressure_window_s = float(pressure_window_s)
        self.escalate_after = int(escalate_after)
        self._lock = make_lock("tenancy.admission")
        self._specs: dict[str, TenantSpec] = {}
        self._rps: dict[str, _Bucket] = {}
        self._rows_ps: dict[str, _Bucket] = {}
        self._admitted: dict[str, int] = {}
        self._shed: dict[tuple[str, str], int] = {}
        #: overload observations inside the current pressure window
        self._overloads: list[float] = []
        self._overloads_total = 0
        for spec in specs:
            self.add_tenant(spec, burst_s=burst_s)

    def add_tenant(self, spec: TenantSpec, *,
                   burst_s: float = 1.0) -> None:
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(
                    f"tenant {spec.name!r} already admitted-controlled"
                )
            self._specs[spec.name] = spec
            if spec.quota_rps is not None:
                self._rps[spec.name] = _Bucket(spec.quota_rps, burst_s)
            if spec.quota_rows_ps is not None:
                self._rows_ps[spec.name] = _Bucket(
                    spec.quota_rows_ps, burst_s)
            self._admitted.setdefault(spec.name, 0)

    def spec(self, name: str) -> TenantSpec:
        with self._lock:
            try:
                return self._specs[name]
            except KeyError:
                raise KeyError(
                    f"unknown tenant {name!r}; have "
                    f"{sorted(self._specs)}"
                ) from None

    # -- the pressure state machine ------------------------------------

    def observe_overload(self, now: float) -> None:
        """Feed one downstream ``Overloaded`` (the batcher's queue-full
        shed) into the pressure window. The fleet calls this at its
        submit seam; operators can also wire it to the flight
        recorder's burst-detection trigger events."""
        with self._lock:
            self._prune_locked(now)
            self._overloads.append(float(now))
            self._overloads_total += 1
            level = self._level_locked()
        telemetry.inc("sbt_tenancy_overloads_total")
        telemetry.set_gauge("sbt_tenancy_pressure_level", float(level))

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.pressure_window_s
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        self._overloads = [t for t in self._overloads if t > cutoff]

    def _level_locked(self) -> int:
        n = len(self._overloads)
        if n == 0:
            return 0
        return 2 if n >= self.escalate_after else 1

    def pressure_level(self, now: float) -> int:
        """0 = normal, 1 = shed batch class, 2 = shed standard too."""
        with self._lock:
            self._prune_locked(now)
            return self._level_locked()

    # -- the decision ---------------------------------------------------

    def admit(self, name: str, rows: int, now: float) -> str | None:
        """Decide one request: returns None (admitted) or the shed
        reason (``"quota"`` | ``"priority"``). Counts both ways."""
        with self._lock:
            spec = self._specs.get(name)
            if spec is None:
                raise KeyError(
                    f"unknown tenant {name!r}; have "
                    f"{sorted(self._specs)}"
                )
            reason: str | None = None
            # quota first: a tenant over its own ceiling is shed even
            # in normal state — absolute entitlements, not pressure
            bucket = self._rps.get(name)
            if bucket is not None and not bucket.take(1.0, now):
                reason = "quota"
            if reason is None:
                bucket = self._rows_ps.get(name)
                if bucket is not None and not bucket.take(
                        float(rows), now):
                    reason = "quota"
            if reason is None:
                self._prune_locked(now)
                level = self._level_locked()
                # level 1 sheds batch (priority level 2), level 2
                # sheds standard (level 1) as well; interactive
                # (level 0) is never priority-shed
                if level > 0 and spec.priority_level >= 3 - level:
                    reason = "priority"
            if reason is None:
                self._admitted[name] += 1
            else:
                key = (name, reason)
                self._shed[key] = self._shed.get(key, 0) + 1
        if reason is None:
            telemetry.inc("sbt_tenancy_admitted_total",
                          labels={"tenant": name})
        else:
            # unlabeled total first (what fleet-level alert rules
            # read — the engine samples exact label sets), then the
            # attribution twin, mirroring the eviction-counter idiom
            telemetry.inc("sbt_tenancy_shed_total")
            telemetry.inc("sbt_tenancy_shed_total",
                          labels={"tenant": name, "reason": reason})
        return reason

    def check(self, name: str, rows: int, now: float) -> None:
        """:meth:`admit`, raising :class:`QuotaExceeded` /
        :class:`AdmissionShed` instead of returning the reason."""
        reason = self.admit(name, rows, now)
        if reason == "quota":
            raise QuotaExceeded(
                name,
                f"tenant {name!r} exceeded its admission quota"
            )
        if reason is not None:
            raise AdmissionShed(
                name, reason,
                f"tenant {name!r} shed under pressure "
                f"(priority {self._specs[name].priority!r})"
            )

    # -- reporting -------------------------------------------------------

    def admitted_counts(self) -> dict[str, int]:
        with self._lock:
            return {k: self._admitted[k] for k in sorted(self._admitted)}

    def shed_counts(self) -> dict[str, dict[str, int]]:
        """{tenant: {reason: count}}, name-sorted — transcript-ready."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            for (name, reason), n in sorted(self._shed.items()):
                out.setdefault(name, {})[reason] = n
            return out

    def state(self, now: float | None = None) -> dict:
        """Deterministic report (``/debug/tenancy``): the pressure
        machine plus per-tenant decision counts. Passing ``now``
        evaluates the live pressure level; omitted, the level reflects
        the last observation (no clock read — report purity)."""
        with self._lock:
            if now is not None:
                self._prune_locked(now)
            return {
                "pressure_level": self._level_locked(),
                "overloads_total": self._overloads_total,
                "overloads_in_window": len(self._overloads),
                "pressure_window_s": self.pressure_window_s,
                "escalate_after": self.escalate_after,
                "tenants": {
                    name: {
                        "priority": spec.priority,
                        "admitted": self._admitted.get(name, 0),
                        "shed": {
                            r: self._shed.get((name, r), 0)
                            for r in ("quota", "priority")
                            if (name, r) in self._shed
                        },
                    }
                    for name, spec in sorted(self._specs.items())
                },
            }
