"""TenantFleet — the composed multi-tenant serving plane.

One registry, N named tenants, one device budget. The fleet wires the
tenancy pieces around the existing single-model machinery without
changing its contracts:

- ``register()`` is ``ModelRegistry.register`` plus the fleet
  bookkeeping: warmup (one CUDA graph a bucket), residency adoption,
  and a per-tenant ``MicroBatcher``.
- ``submit()`` is the admission seam: quota/priority decisions happen
  HERE (counted per tenant), admitted requests are tagged into the
  WFQ scheduler — nothing touches a batcher yet.
- ``dispatch()`` drains the WFQ in virtual-finish order and feeds
  each request to its tenant's batcher: pop order IS downstream batch
  composition, so fairness and determinism are the same property. A
  batcher's ``Overloaded`` here is both counted per tenant
  (``sbt_serving_shed_total{reason="overload",tenant=}``) and fed
  back into the admission controller's pressure machine — the
  backpressure-to-policy loop the tentpole names.

Stepped batchers (``threaded=False``, the default) make the whole
fleet a pure function of (workload, specs, seed) under a virtual
clock — the replay drill's mode. Threaded batchers serve live
traffic with identical policy decisions; only batch timing differs.

Blast-radius containment: a :class:`QuarantineMachine`
rides every fleet. Repeated failures attributed to ONE tenant
(dispatch faults, degraded batchers, restore failures) trip that
tenant into quarantine — its requests shed with a distinct
:class:`~spark_bagging_tpu_torch.tenancy.admission.TenantQuarantined`, its
refit budget released back to the pool, its residency slot freed —
while every other tenant's traffic proceeds untouched (no capture on
a request's forward path, bitwise-identical outputs: the tenant-chaos
drill's asserted invariant). Recovery is seeded exponential backoff
plus a single probe request; a failed probe re-trips with escalated
backoff.

The port's copy of the JAX package's ``tenancy/fleet.py``. Where the JAX
fleet persists a tenant's executables at registration and its restores
reload them, the port persists nothing and a restore re-captures the
tenant's recorded ladder (``tenancy/residency.py``): restore time is
capture time, counted in ``sbt_serving_compiles_total``. The stepped
drive keeps every such capture off the request path (residency is
touched before each tenant's own forwards run). A threaded drive
restores on the dispatch thread, and a tenant demoted while its
requests wait in its batcher captures on demand on the batcher's
thread — the thrash the :meth:`TenantFleet.dispatch` docstring names.
"""

from __future__ import annotations

import bisect
import hashlib
import random
import time
from collections import deque
from typing import Any, Iterable

from spark_bagging_tpu_torch import faults as faults_mod
from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.faults import FaultError
from spark_bagging_tpu_torch.serving.batcher import Degraded, Overloaded
from spark_bagging_tpu_torch.telemetry import perf as _perf
from spark_bagging_tpu_torch.telemetry import tracing
from spark_bagging_tpu_torch.tenancy.admission import (
    AdmissionController,
    AdmissionShed,
    TenantQuarantined,
)
from spark_bagging_tpu_torch.tenancy.budget import RefitBudgeter
from spark_bagging_tpu_torch.tenancy.residency import ResidencyManager
from spark_bagging_tpu_torch.tenancy.spec import TenantSpec
from spark_bagging_tpu_torch.tenancy.wfq import WFQScheduler

#: bounded per-tenant latency reservoir (sorted insert; p99 export)
_LATENCY_KEEP = 2048

#: bounded recent-quarantine-shed ring: trace ids for the
#: ``/debug/tenancy`` ↔ ``/debug/tail`` incident join —
#: a ring, not the event log, so a hammering quarantined tenant
#: cannot grow the transition transcript without bound
_SHED_LOG_KEEP = 256


class _TenantHealth:
    """One tenant's containment state (owned by QuarantineMachine)."""

    __slots__ = ("state", "failures", "until", "trips",
                 "consecutive_trips", "probes", "recoveries", "sheds",
                 "kinds", "rng")

    def __init__(self, rng: random.Random):
        self.state = "healthy"  # healthy | quarantined | probing
        self.failures: list[float] = []
        self.until = 0.0
        self.trips = 0
        self.consecutive_trips = 0
        self.probes = 0
        self.recoveries = 0
        self.sheds = 0
        self.kinds: dict[str, int] = {}
        self.rng = rng


# sbt-lint: shared-state
class QuarantineMachine:
    """Per-tenant failure-window circuit breaker with seeded backoff.

    ``threshold`` failures inside ``window_s`` (on the caller-passed
    clock — no wall reads, so replay transcripts are byte-identical)
    trip a tenant into ``quarantined``. While quarantined its requests
    are shed with :class:`TenantQuarantined`. Once the backoff elapses
    the FIRST request through :meth:`admit` becomes the single probe
    (state ``probing``; everything else keeps shedding): a successful
    probe recovers the tenant and resets the backoff ladder, a failed
    one re-trips with the next rung. Backoff is
    ``min(max_backoff_s, backoff_s * factor**consecutive_trips)``
    jittered by a per-tenant ``random.Random`` seeded from
    ``(seed, tenant)`` — reproducible, but two tenants tripping at the
    same instant never synchronize their recovery stampedes.

    The machine is pure bookkeeping: the trip's fleet-level side
    effects (refit-budget release, residency eviction) belong to the
    :class:`TenantFleet`, keyed off the booleans returned here. Its
    lock is a leaf — nothing is called back under it.
    """

    def __init__(
        self,
        names: Iterable[str],
        *,
        threshold: int = 3,
        window_s: float = 1.0,
        backoff_s: float = 0.5,
        backoff_factor: float = 2.0,
        max_backoff_s: float = 30.0,
        seed: int = 0,
    ) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if backoff_s <= 0:
            raise ValueError(f"backoff_s must be > 0, got {backoff_s}")
        if backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {backoff_factor}"
            )
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_s = float(max_backoff_s)
        self.seed = int(seed)
        self._lock = make_lock("tenancy.quarantine")
        self._t: dict[str, _TenantHealth] = {
            str(n): _TenantHealth(random.Random(
                int.from_bytes(
                    hashlib.sha256(
                        f"{self.seed}|quarantine|{n}".encode()
                    ).digest()[:8],
                    "big",
                )
            ))
            for n in names
        }
        self._events: list[dict] = []
        self._seq = 0
        # recent quarantine sheds with the shedding request's trace id
        # (bounded ring, newest last) — joins /debug/tenancy incidents
        # against /debug/tail and flight dumps
        self._shed_log: deque[dict] = deque(maxlen=_SHED_LOG_KEEP)
        self._shed_seq = 0

    def _h(self, name: str) -> _TenantHealth:
        # sbt-lint: disable=shared-state-unlocked — _locked-path helper, every caller holds self._lock
        try:
            return self._t[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; have {sorted(self._t)}"
            ) from None

    def _event(self, kind: str, tenant: str, **extra: Any) -> None:
        # sbt-lint: disable=shared-state-unlocked — _locked-path helper, every caller holds self._lock
        self._seq += 1
        self._events.append({"kind": kind, "tenant": tenant,
                             "seq": self._seq, **extra})

    # -- the decision seams ---------------------------------------------

    def admit(self, name: str, now: float, *,
              trace_id: str | None = None) -> str:
        """Gate one request: ``"healthy"`` (proceed), ``"probe"``
        (proceed, and this request's outcome decides recovery), or
        raises :class:`TenantQuarantined` (shed, counted).
        ``trace_id`` stamps the probe event and the shed — the join
        key between quarantine incidents and the tail explainer."""
        probe = False
        with self._lock:
            h = self._h(name)
            if h.state == "healthy":
                return "healthy"
            if h.state == "quarantined" and now >= h.until:
                h.state = "probing"
                h.probes += 1
                if trace_id is not None:
                    self._event("probe", name, trace_id=trace_id)
                else:
                    self._event("probe", name)
                probe = True
            else:
                h.sheds += 1
                self._shed_seq += 1
                self._shed_log.append({
                    "tenant": name, "shed_seq": self._shed_seq,
                    "trace_id": trace_id,
                })
        if probe:
            telemetry.inc("sbt_tenant_quarantine_probes_total",
                          labels={"tenant": name})
            return "probe"
        # unlabeled total first, then the attribution twin — the same
        # idiom as every tenancy shed counter
        telemetry.inc("sbt_tenancy_shed_total")
        telemetry.inc("sbt_tenancy_shed_total",
                      labels={"tenant": name, "reason": "quarantine"})
        telemetry.inc("sbt_tenant_quarantine_shed_total")
        telemetry.inc("sbt_tenant_quarantine_shed_total",
                      labels={"tenant": name})
        raise TenantQuarantined(
            name, f"tenant {name!r} is quarantined (blast-radius "
            "containment); retry after backoff", trace_id=trace_id)

    def record_failure(self, name: str, now: float, kind: str, *,
                       trace_id: str | None = None) -> bool:
        """Feed one tenant-attributed failure into the window. Returns
        True iff THIS failure tripped quarantine (the caller then runs
        the fleet-level side effects). ``trace_id`` identifies the
        failing request on the trip event when known."""
        tripped = False
        with self._lock:
            h = self._h(name)
            h.kinds[kind] = h.kinds.get(kind, 0) + 1
            if h.state == "healthy":
                cutoff = now - self.window_s
                h.failures = [t for t in h.failures if t > cutoff]
                h.failures.append(float(now))
                if len(h.failures) >= self.threshold:
                    self._trip_locked(h, name, now, trace_id=trace_id)
                    tripped = True
        telemetry.inc("sbt_tenant_quarantine_failures_total",
                      labels={"tenant": name, "kind": kind})
        if tripped:
            self._count_trip(name)
        return tripped

    def probe_result(self, name: str, now: float, ok: bool) -> bool:
        """Settle the in-flight probe. Returns True iff a failed probe
        re-tripped quarantine (escalated backoff)."""
        retripped = False
        recovered = False
        with self._lock:
            h = self._h(name)
            if h.state != "probing":
                return False
            if ok:
                h.state = "healthy"
                h.consecutive_trips = 0
                h.failures = []
                h.recoveries += 1
                self._event("recover", name)
                recovered = True
            else:
                self._trip_locked(h, name, now)
                retripped = True
        if recovered:
            telemetry.inc("sbt_tenant_quarantine_recoveries_total",
                          labels={"tenant": name})
            self._export_active()
        if retripped:
            self._count_trip(name)
        return retripped

    def probe_aborted(self, name: str) -> None:
        """The probe request never reached a verdict (shed upstream of
        the tenant's own path, e.g. by admission): back to quarantined
        with the SAME deadline, so the next eligible request probes."""
        with self._lock:
            h = self._h(name)
            if h.state == "probing":
                h.state = "quarantined"
                self._event("probe_aborted", name)

    def _trip_locked(self, h: _TenantHealth, name: str,
                     now: float, trace_id: str | None = None) -> None:
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        delay = min(self.max_backoff_s,
                    self.backoff_s
                    * self.backoff_factor ** h.consecutive_trips)
        # jitter from the tenant's private seeded stream: deterministic
        # per (seed, tenant, trip index), never synchronized across
        # tenants
        delay *= 0.75 + 0.5 * h.rng.random()
        h.consecutive_trips += 1
        h.trips += 1
        h.state = "quarantined"
        h.until = float(now) + delay
        h.failures = []
        if trace_id is not None:
            self._event("trip", name, backoff_s=round(delay, 9),
                        until=round(h.until, 9), trace_id=trace_id)
        else:
            self._event("trip", name, backoff_s=round(delay, 9),
                        until=round(h.until, 9))

    def _count_trip(self, name: str) -> None:
        telemetry.inc("sbt_tenant_quarantine_trips_total")
        telemetry.inc("sbt_tenant_quarantine_trips_total",
                      labels={"tenant": name})
        telemetry.emit_event({
            "kind": "tenant_quarantine_trip", "tenant": name,
        })
        self._export_active()

    def _export_active(self) -> None:
        with self._lock:
            n = sum(1 for h in self._t.values() if h.state != "healthy")
        telemetry.set_gauge("sbt_tenant_quarantine_active", float(n))

    # -- reporting ------------------------------------------------------

    def healthy(self, name: str) -> bool:
        with self._lock:
            return self._h(name).state == "healthy"

    def events(self) -> list[dict]:
        """The full transition log (copy), seq-ordered — the
        quarantine transcript the tenant-chaos drill digests."""
        with self._lock:
            return [dict(e) for e in self._events]

    def counts(self) -> dict[str, dict[str, int]]:
        """{"trips"|"sheds"|"probes"|"recoveries": {tenant: n}},
        name-sorted, zero-count tenants omitted — transcript-ready."""
        with self._lock:
            out: dict[str, dict[str, int]] = {
                "trips": {}, "sheds": {}, "probes": {}, "recoveries": {},
            }
            for name in sorted(self._t):
                h = self._t[name]
                for key, val in (("trips", h.trips), ("sheds", h.sheds),
                                 ("probes", h.probes),
                                 ("recoveries", h.recoveries)):
                    if val:
                        out[key][name] = val
            return out

    def state(self) -> dict:
        """Deterministic report (``/debug/tenancy``): config + every
        tenant the machine has ever acted on."""
        with self._lock:
            return {
                "threshold": self.threshold,
                "window_s": self.window_s,
                "backoff_s": self.backoff_s,
                "backoff_factor": self.backoff_factor,
                "max_backoff_s": self.max_backoff_s,
                "seed": self.seed,
                "events": len(self._events),
                # trace-stamped quarantine sheds (bounded ring) — the
                # /debug/tail join surface
                "recent_sheds": [dict(s) for s in self._shed_log],
                "tenants": {
                    name: {
                        "state": h.state,
                        "trips": h.trips,
                        "consecutive_trips": h.consecutive_trips,
                        "probes": h.probes,
                        "recoveries": h.recoveries,
                        "sheds": h.sheds,
                        "until": (round(h.until, 9)
                                  if h.state != "healthy" else None),
                        "failures": dict(sorted(h.kinds.items())),
                    }
                    for name, h in sorted(self._t.items())
                    if h.trips or h.sheds or h.kinds
                },
            }


# sbt-lint: shared-state
class TenantFleet:
    """N tenants sharing one registry + device, policy-enforced."""

    def __init__(
        self,
        specs: Iterable[TenantSpec],
        *,
        registry: Any = None,
        residency_capacity: int | None = None,
        aot_root: str | None = None,
        plane: Any = None,
        pressure_window_s: float = 1.0,
        escalate_after: int = 3,
        refit_total_per_window: int = 4,
        refit_window_s: float = 60.0,
        quarantine_threshold: int = 3,
        quarantine_window_s: float = 1.0,
        quarantine_backoff_s: float = 0.5,
        quarantine_backoff_factor: float = 2.0,
        quarantine_max_backoff_s: float = 30.0,
        quarantine_seed: int = 0,
        threaded: bool = False,
        batcher_opts: dict | None = None,
    ) -> None:
        specs = list(specs)
        if not specs:
            raise ValueError("TenantFleet needs at least one TenantSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        if registry is None:
            from spark_bagging_tpu_torch.serving.registry import ModelRegistry

            registry = ModelRegistry()
        self.registry = registry
        self.specs: dict[str, TenantSpec] = {s.name: s for s in specs}
        self.admission = AdmissionController(
            specs, pressure_window_s=pressure_window_s,
            escalate_after=escalate_after,
        )
        self.wfq = WFQScheduler({s.name: s.weight for s in specs})
        self.budget = RefitBudgeter(
            specs, total_per_window=refit_total_per_window,
            window_s=refit_window_s,
        )
        self.quarantine = QuarantineMachine(
            names,
            threshold=quarantine_threshold,
            window_s=quarantine_window_s,
            backoff_s=quarantine_backoff_s,
            backoff_factor=quarantine_backoff_factor,
            max_backoff_s=quarantine_max_backoff_s,
            seed=quarantine_seed,
        )
        self.residency: ResidencyManager | None = None
        if residency_capacity is not None:
            if aot_root is None:
                raise ValueError(
                    "residency_capacity needs aot_root (the JAX "
                    "package's demotion persist directory; validated, "
                    "never written here)"
                )
            self.residency = ResidencyManager(
                registry, capacity=residency_capacity,
                aot_root=aot_root, plane=plane,
            )
        self._threaded = bool(threaded)
        self._batcher_opts = dict(batcher_opts or {})
        self._lock = make_lock("tenancy.fleet")
        self._batchers: dict[str, Any] = {}
        #: per-tenant downstream sheds {(tenant, reason): n}
        self._sheds: dict[tuple[str, str], int] = {}
        self._submitted: dict[str, int] = {}
        self._served_rows: dict[str, int] = {}
        self._latency_ms: dict[str, list[float]] = {}
        telemetry.set_gauge("sbt_tenancy_tenants", float(len(specs)))

    # -- lifecycle ------------------------------------------------------

    def register(self, name: str, model: Any, *,
                 warmup: bool = True,
                 batcher_opts: dict | None = None,
                 **executor_opts: Any) -> Any:
        """Install ``model`` as tenant ``name``'s serving bag."""
        spec = self.specs.get(name)
        if spec is None:
            raise KeyError(
                f"no TenantSpec for {name!r}; have {sorted(self.specs)}"
            )
        ex = self.registry.register(name, model, warmup=warmup,
                                    **executor_opts)
        if self.residency is not None:
            # no eager persist (a CUDA graph cannot be serialized): a
            # later demote records the ladder its restore re-captures
            self.residency.adopt(name)
        opts = {**self._batcher_opts, **(batcher_opts or {})}
        opts.setdefault("threaded", self._threaded)
        batcher = self.registry.batcher(name, **opts)
        with self._lock:
            self._batchers[name] = batcher
        return ex

    def batcher(self, name: str) -> Any:
        with self._lock:
            try:
                return self._batchers[name]
            except KeyError:
                raise KeyError(
                    f"tenant {name!r} has no registered model yet"
                ) from None

    def close(self) -> None:
        with self._lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
        for b in batchers:
            b.close()

    # -- the serve path -------------------------------------------------

    def submit(self, name: str, X: Any, *, now: float,
               mode: str = "aggregate",
               deadline_ms: float | None = None) -> float:
        """Admit + fair-queue one request; returns its WFQ finish tag.

        Raises :class:`~spark_bagging_tpu_torch.tenancy.admission.QuotaExceeded`
        / :class:`~spark_bagging_tpu_torch.tenancy.admission.AdmissionShed`
        when admission sheds it (already counted), and
        :class:`~spark_bagging_tpu_torch.tenancy.admission.TenantQuarantined`
        while the tenant is contained. The request reaches its batcher
        at the next :meth:`dispatch`.

        With telemetry enabled the fleet mints the request's
        :class:`~spark_bagging_tpu_torch.telemetry.tracing.TraceContext`
        HERE — before the quarantine gate — so the journey covers
        every stage the request actually traverses (admission → WFQ →
        residency → batcher) and a shed resolves the trace with a
        terminal shed span instead of vanishing. The
        quarantine/admission gate interval lands in the breakdown as
        ``admission_ms``; sheds carry ``trace_id`` on the raised
        exception."""
        # the journey starts here: one trace per request, tenant on
        # every span — minted before the quarantine gate so even a
        # contained tenant's sheds are joinable by trace id. Disabled
        # telemetry mints nothing: the whole journey plumbing below
        # is `if trace is not None` (the zero-cost-unarmed contract).
        trace = (tracing.request_context()
                 if telemetry.enabled() else None)
        tid = trace.trace_id if trace is not None else None
        if trace is not None:
            trace.journey = {"tenant": name, "t0": time.perf_counter()}
        # quarantine gates BEFORE admission: a contained tenant's
        # traffic must not even drain its own quota buckets, and its
        # single recovery probe is chosen here
        try:
            verdict = self.quarantine.admit(name, now, trace_id=tid)
        except TenantQuarantined:
            self._resolve_shed(trace, name, "quarantine")
            raise
        probe = verdict == "probe"
        rows = int(getattr(X, "shape", (1,))[0])
        try:
            with tracing.use(trace):
                with telemetry.span("tenancy_admission", tenant=name,
                                    rows=rows):
                    self.admission.check(name, rows, now)
        except Exception as exc:
            if probe:
                # the probe never reached the tenant's own path — keep
                # the quarantine deadline, probe again next request
                self.quarantine.probe_aborted(name)
            if isinstance(exc, AdmissionShed):
                exc.trace_id = tid
                self._resolve_shed(trace, name, exc.reason)
            raise
        if trace is not None:
            j = trace.journey
            t1 = time.perf_counter()
            j["admission_ms"] = (t1 - j["t0"]) * 1e3
            j["t1"] = t1
        with self._lock:
            self._submitted[name] = self._submitted.get(name, 0) + rows
        return self.wfq.enqueue(
            name, (X, mode, deadline_ms, probe, trace),
            cost=float(rows))

    def dispatch(self, *, now: float,
                 run_pending: bool = True) -> list[dict]:
        """Drain the WFQ in fair order into the per-tenant batchers.

        Returns one record per drained request:
        ``{"tenant", "future", "rows", "shed"}`` — ``future`` is None
        iff the batcher shed it (``shed`` carries the reason, the
        overload case also feeds :meth:`AdmissionController.
        observe_overload`). With stepped batchers and
        ``run_pending=True`` every touched tenant's queue is then
        served on this thread, in tenant-name order (the churn drill's
        idiom) — with residency admitting each tenant back immediately
        BEFORE its own forwards run (the counted restore path). The
        placement is load-bearing: touching at drain time instead
        would let a window that drains more distinct tenants than the
        residency budget demote the earliest-touched ones again before
        their forwards ran, and they would capture on demand on the
        request path — breaking the no-capture-on-a-request promise
        for every over-budget window. Threaded batchers forward concurrently, so
        there the tenant is made resident at drain time (its forwards
        may start before this loop ends) and an over-budget window
        genuinely thrashes — bounded tenancy needs the stepped drive."""
        out: list[dict] = []
        touched: set[str] = set()
        stepped = run_pending and not self._threaded
        while len(self.wfq):
            head = self.wfq.head_tenant()
            try:
                tenant, (X, mode, deadline_ms, probe, trace) = (
                    self.wfq.pop())
            except FaultError:
                # the pop probe fired BEFORE the heap mutation: the
                # head request stays queued for the next dispatch.
                # Attribute the fault to the head tenant and end this
                # drain pass — containment, never an escaping fault
                self._note_failure(head, now, "wfq")
                break
            tid = trace.trace_id if trace is not None else None
            if trace is not None:
                # the WFQ stage closes at the pop: fair-queue wait is
                # pop minus enqueue, exactly
                j = trace.journey
                t_pop = time.perf_counter()
                j["wfq_ms"] = (t_pop - j.get("t1", j["t0"])) * 1e3
                j["t_pop"] = t_pop
            if self.residency is not None and not stepped:
                t_r0 = time.perf_counter()
                try:
                    status = self.residency.touch(tenant)
                except FaultError:
                    # an injected restore fault costs THIS tenant a
                    # capture on demand, never the dispatch pass
                    self._note_failure(tenant, now, "restore",
                                       trace_id=tid)
                else:
                    if status == "restored":
                        # threaded mode restores BEFORE the batcher
                        # submit: the cost sits inside the dispatch
                        # interval, carved out as its own stage
                        self._note_restore(
                            tenant, (time.perf_counter() - t_r0) * 1e3,
                            (trace,), pre_submit=True)
            rows = int(getattr(X, "shape", (1,))[0])
            rec: dict[str, Any] = {"tenant": tenant, "future": None,
                                   "rows": rows, "shed": None,
                                   "trace_id": tid}
            failure_kind: str | None = None
            try:
                if faults_mod.ACTIVE is not None:
                    faults_mod.fire("fleet.dispatch", tenant=tenant)
                with tracing.use(trace):
                    with telemetry.span("tenancy_dispatch",
                                        tenant=tenant, rows=rows):
                        rec["future"] = self.batcher(tenant).submit(
                            X, mode=mode, deadline_ms=deadline_ms,
                            trace=trace)
                touched.add(tenant)
                with self._lock:
                    self._served_rows[tenant] = (
                        self._served_rows.get(tenant, 0) + rows)
            except Overloaded:
                rec["shed"] = "overload"
                self.admission.observe_overload(now)
            except Degraded:
                rec["shed"] = "degraded"
                failure_kind = "degraded"
            except FaultError:
                # the tenant-scoped dispatch fault: shed THIS request
                # with a distinct reason and feed the quarantine
                # window — the blast radius is one tenant's record,
                # not the drain loop
                rec["shed"] = "fault"
                failure_kind = "dispatch"
            if probe:
                if rec["future"] is not None:
                    # the single recovery probe made it through the
                    # tenant's own path: recover + re-pool its budget
                    self.quarantine.probe_result(tenant, now, True)
                    self.budget.readmit(tenant)
                elif failure_kind is not None:
                    # the probe failed on the tenant's own path:
                    # re-trip with escalated backoff
                    self.quarantine.probe_result(tenant, now, False)
                else:
                    # overload is the fleet's weather, not the
                    # tenant's health — probe again next request
                    self.quarantine.probe_aborted(tenant)
            elif failure_kind is not None:
                self._note_failure(tenant, now, failure_kind,
                                   trace_id=tid)
            if rec["shed"] is not None:
                with self._lock:
                    key = (tenant, rec["shed"])
                    self._sheds[key] = self._sheds.get(key, 0) + 1
                # the tenant-labeled twin of the batcher's own shed
                # counter: same series, tenant
                # dimension added at the seam that knows it
                telemetry.inc(
                    "sbt_serving_shed_total",
                    labels={"reason": rec["shed"], "tenant": tenant},
                )
                self._resolve_shed(trace, tenant, rec["shed"])
            out.append(rec)
        if stepped:
            for tenant in sorted(touched):
                if self.residency is not None:
                    t_r0 = time.perf_counter()
                    try:
                        status = self.residency.touch(tenant)
                    except FaultError:
                        self._note_failure(tenant, now, "restore")
                    else:
                        if status == "restored":
                            # stepped mode restores while the window's
                            # requests wait in their batcher queues:
                            # the cost would otherwise masquerade as
                            # queue wait — stamp it onto this window's
                            # pending traces so the breakdown carves
                            # it out as restore_ms
                            dt_ms = (time.perf_counter() - t_r0) * 1e3
                            traces = []
                            for r in out:
                                if (r["tenant"] == tenant
                                        and r["future"] is not None):
                                    r["restored"] = True
                                    traces.append(getattr(
                                        r["future"], "trace", None))
                            self._note_restore(tenant, dt_ms, traces,
                                               pre_submit=False)
                self.batcher(tenant).run_pending()
        return out

    def _note_restore(self, tenant: str, dt_ms: float,
                      traces: Iterable[Any], *,
                      pre_submit: bool) -> None:
        """Attribute one measured restore (its re-captures) to the requests that
        absorbed it: ``restore_pre_ms`` sits inside the dispatch
        interval (threaded mode touches before the batcher submit),
        ``restore_post_ms`` inside the batcher queue wait (stepped
        mode touches before ``run_pending``) — the breakdown fix-up
        subtracts each from its host stage, keeping the decomposition
        exact."""
        key = "restore_pre_ms" if pre_submit else "restore_post_ms"
        stamped = []
        for tr in traces:
            if tr is not None and tr.journey is not None:
                tr.journey[key] = tr.journey.get(key, 0.0) + dt_ms
                stamped.append(tr.trace_id)
        if telemetry.enabled():
            telemetry.emit_event({
                "kind": "tenancy_restore", "tenant": tenant,
                "restore_ms": round(dt_ms, 3),
                "trace_ids": stamped[:8],
            })

    def _resolve_shed(self, trace: Any, tenant: str,
                      reason: str) -> None:
        """Resolve a shed request's trace with a terminal shed span
        and a stage-exact breakdown: quota/priority/quarantine sheds
        end at admission (the gate interval IS the request), overload/
        degraded/fault sheds end at dispatch — either way the journey
        stages tile the request's whole wall-clock and the record is
        fed to the perf plane so ``/debug/tail`` can verdict it."""
        if trace is None:
            return
        t_shed = time.perf_counter()
        j = trace.journey if trace.journey is not None else {}
        j["shed"] = reason
        pre = float(j.get("restore_pre_ms", 0.0))
        bd: dict[str, Any] = {
            "tenant": tenant, "path": "shed", "shed": reason,
            "queue_ms": 0.0, "batch_ms": 0.0, "forward_ms": 0.0,
            "batch_size": 0, "restore_ms": pre, "model_name": tenant,
        }
        if "t_pop" in j:
            bd["admission_ms"] = j.get("admission_ms", 0.0)
            bd["wfq_ms"] = j.get("wfq_ms", 0.0)
            bd["dispatch_ms"] = (t_shed - j["t_pop"]) * 1e3 - pre
        else:
            bd["admission_ms"] = ((t_shed - j["t0"]) * 1e3
                                  if "t0" in j else 0.0)
            bd["wfq_ms"] = 0.0
            bd["dispatch_ms"] = 0.0
        if "t0" in j:
            bd["total_ms"] = (t_shed - j["t0"]) * 1e3
        trace.breakdown.update(bd)
        with tracing.use(trace):
            with telemetry.span("tenancy_shed", tenant=tenant,
                                reason=reason):
                pass
        telemetry.emit_event({
            "kind": "tenancy_shed", "tenant": tenant,
            "reason": reason, "trace_id": trace.trace_id,
        })
        ap = _perf.ACTIVE
        if ap is not None:
            ap.observe_breakdown(bd, trace_id=trace.trace_id)

    def _note_failure(self, tenant: str | None, now: float,
                      kind: str, *,
                      trace_id: str | None = None) -> None:
        """Feed one tenant-attributed failure into the quarantine
        window; on a trip, run the fleet-level containment edges."""
        if tenant is None:
            return
        if self.quarantine.record_failure(tenant, now, kind,
                                          trace_id=trace_id):
            self._on_trip(tenant, now)

    def _on_trip(self, tenant: str, now: float) -> None:
        # release the refit entitlement back to the pool: survivors'
        # quotas recompute over the remaining weight mass
        self.budget.release(tenant)
        if self.residency is not None:
            try:
                # free the residency slot NOW (non-destructive demote:
                # the recorded ladder keeps the tenant restorable)
                self.residency.evict(tenant)
            except FaultError:
                # an injected demote_persist fault may not strand the
                # trip: it fires before the release, so the tenant
                # keeps its programs and the slot is reclaimed by
                # normal LRU enforcement at the next touch
                self._note_failure(tenant, now, "demote")

    # -- refit budgeting -------------------------------------------------

    def refit_allowed(self, name: str, now: float) -> bool:
        """The :class:`RefitBudgeter` decision for ``name`` — also the
        hook to pass an ``OnlineTrainer`` as ``refit_budget=``
        (via :meth:`RefitBudgeter.for_tenant`). A quarantined tenant
        never refits (its budget is pooled), and an injected
        ``budget.refit`` fault is a counted denial, not an escape."""
        if not self.quarantine.healthy(name):
            telemetry.inc("sbt_tenancy_refit_denied_total",
                          labels={"tenant": name})
            return False
        try:
            return self.budget.allow(name, now)
        except FaultError:
            telemetry.inc("sbt_tenancy_refit_denied_total",
                          labels={"tenant": name})
            return False

    # -- latency accounting ----------------------------------------------

    def note_latency(self, name: str, ms: float, *,
                     trace_id: str | None = None) -> None:
        """Record one served request's wall latency (host-band data:
        exported as gauges, never digested). Besides the in-object
        p99 reservoir this feeds the real log-scale
        ``sbt_tenancy_latency_seconds{tenant=}`` histogram (exemplar:
        ``trace_id``), so fleet merge and ``/fleet/varz`` quantiles
        cover tenant tails exactly — bucket counts merge across
        processes, in-object p99s cannot."""
        with self._lock:
            res = self._latency_ms.setdefault(name, [])
            bisect.insort(res, float(ms))
            if len(res) > _LATENCY_KEEP:
                res.pop()  # drop the max: keep the reservoir bounded
        if telemetry.enabled():
            telemetry.observe("sbt_tenancy_latency_seconds",
                              float(ms) / 1e3,
                              labels={"tenant": name},
                              exemplar=trace_id)

    @staticmethod
    def _p99(sorted_ms: list[float]) -> float | None:
        if not sorted_ms:
            return None
        i = min(len(sorted_ms) - 1,
                int(0.99 * (len(sorted_ms) - 1) + 0.5))
        return sorted_ms[i]

    def latency_p99_ms(self) -> dict[str, float]:
        with self._lock:
            out = {}
            for name in sorted(self._latency_ms):
                p = self._p99(self._latency_ms[name])
                if p is not None:
                    out[name] = p
            return out

    def tail_p99_ms(self) -> float | None:
        """p99 over the TAIL tenants — everyone but the top tenant by
        submitted rows (the Zipf head). The fleet SLO the tenancy
        alert rules burn against."""
        per = self.latency_p99_ms()
        if not per:
            return None
        with self._lock:
            ranked = sorted(self._submitted,
                            key=lambda t: (-self._submitted[t], t))
        head = ranked[0] if ranked else None
        tail = [p for t, p in per.items() if t != head]
        if not tail:
            return max(per.values())
        return max(tail)

    def export_gauges(self) -> None:
        """Per-tenant latency gauges + the tail SLO gauge — called at
        scrape time by the exposition server (like the capacity
        plane's export) and at snapshot time by the drill."""
        for name, p in self.latency_p99_ms().items():
            telemetry.set_gauge("sbt_tenancy_latency_p99_ms", p,
                                labels={"tenant": name})
        tail = self.tail_p99_ms()
        if tail is not None:
            telemetry.set_gauge("sbt_tenancy_tail_p99_ms", tail)

    # -- reporting -------------------------------------------------------

    def shed_counts(self) -> dict[str, dict[str, int]]:
        """Downstream (batcher) sheds per tenant, name-sorted."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            for (name, reason), n in sorted(self._sheds.items()):
                out.setdefault(name, {})[reason] = n
            return out

    def served_rows(self) -> dict[str, int]:
        with self._lock:
            return dict(sorted(self._served_rows.items()))

    def report(self) -> dict:
        """The ``/debug/tenancy`` document: every policy surface's
        deterministic state, one JSON object."""
        with self._lock:
            registered = sorted(self._batchers)
        return {
            "tenants": [self.specs[n].to_dict()
                        for n in sorted(self.specs)],
            "registered": registered,
            "admission": self.admission.state(),
            "wfq": self.wfq.state(),
            "residency": (None if self.residency is None
                          else self.residency.state()),
            "refit_budget": self.budget.state(),
            "quarantine": self.quarantine.state(),
            "downstream_sheds": self.shed_counts(),
            "served_rows": self.served_rows(),
            "latency_p99_ms": self.latency_p99_ms(),
            "tail_p99_ms": self.tail_p99_ms(),
        }
