"""Deterministic fault injection — chaos experiments as pure functions.

A copy of the JAX package's ``faults.py`` (the port keeps its own, as
it keeps every module it needs). A :class:`FaultPlan` is a seeded
schedule of faults armed at named **injection points** — probes in
the serving seams (the batcher's worker loop and batch forward, the
executor's slab forward, the registry's swap pre-capture and
``save()`` I/O steps, the unified program-cache insert, the checkpoint
writer's swap window). A chaos experiment is then a byte-reproducible
function of ``(plan, seed)``: the same plan armed over the same
deterministic traffic injects the same faults at the same hit indices,
run after run, and in either package (``SITES`` and the seeded
``p``-draws are the JAX package's).

Cost contract: **an unarmed process pays nothing.** Probes are written
``if faults.ACTIVE is not None: faults.fire(site)`` — one module
attribute read on the hot path, no lock, no allocation. All plan
bookkeeping (hit counters, seeded draws) happens under the plan's own
lock only while a plan is armed, i.e. only inside a chaos experiment.

Fault grammar (one :class:`FaultSpec` per entry)::

    {"site": "batcher.batch_forward",   # injection point name (SITES)
     "action": "transient",             # what firing does (ACTIONS)
     "at": [3, 7],                      # fire on these 1-based hits...
     "every": 5,                        # ...or every Nth hit...
     "p": 0.1,                          # ...or a seeded coin per hit
     "times": 2,                        # cap total fires (default inf)
     "shard": 1,                        # for action "shard"
     "delay_ms": 5.0,                   # for action "delay"
     "tenant": "t1",                    # only fire for this tenant's hits
     "message": "injected"}             # carried on the raised fault

A spec carrying ``tenant`` only considers probe hits whose call site
passed a matching ``tenant=`` info kwarg, and its trigger indices
(``at`` / ``every``) count THAT tenant's hits alone — the blast-radius
drills aim a schedule at one tenant without having to predict how
interleaved fleet traffic lands on the shared per-site counter.

Actions:

- ``error``     — raise :class:`FaultInjected` (permanent failure);
- ``transient`` — raise :class:`TransientFault` (``transient=True`` —
  the batcher's retry-with-backoff treats it as retryable);
- ``poison``    — on site ``batcher.submit``: :meth:`FaultPlan.fire`
  returns True and the request is marked poisoned (its batch's forward
  raises :class:`PoisonedRequest` until bisection isolates it);
- ``shard``     — raise :class:`ShardFault` carrying ``shard`` (a mesh
  serving executor drops that shard and degrades to the
  surviving-replica aggregate);
- ``kill``      — raise :class:`SimulatedKill` (the torn-write drills:
  a crash at an I/O step, delivered as an exception the drill's
  ``save()`` caller observes exactly where a SIGKILL would land);
- ``delay``     — sleep ``delay_ms`` (latency injection; timed-mode
  soaks only — a virtual-clock replay's batching never sees it).

``p``-draws are per-spec ``random.Random`` streams seeded from
``(plan seed, site, spec index)``, so probabilistic faults are exactly
as reproducible as scheduled ones. :meth:`FaultPlan.snapshot` reports
hits and fires per site — the counts a chaos replay asserts identical
across repeats — and :meth:`FaultPlan.digest` is the plan's canonical
sha256 identity.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
from typing import Any, Iterable

from spark_bagging_tpu_torch import telemetry

PLAN_SCHEMA_VERSION = 1

#: injection points compiled into the tree — the name is the contract
#: (plans referencing unknown sites are rejected loudly, so a renamed
#: seam cannot silently turn a chaos suite into a no-op)
SITES: dict[str, str] = {
    "batcher.submit": "per admitted request (poison marks land here)",
    "batcher.worker": "per worker-loop iteration (crash/supervision drills)",
    "batcher.batch_forward": "per coalesced-batch forward attempt",
    "executor.forward_piece": "per bucket-shaped slab forward",
    "executor.mesh_forward": "per slab forward on a mesh executor (shard loss)",
    "program_cache.put": "per unified-cache insert",
    "registry.swap.precompile": "per warm bucket pre-compile inside swap()",
    "registry.save.checkpoint": "after the checkpoint write inside save()",
    "registry.save.aot": "after the AOT executable write inside save()",
    "registry.save.manifest": "before the serve_config.json commit rename",
    "checkpoint.write": "inside the checkpoint writer, before its atomic swap",
    "aot.save": "inside save_executables, before its atomic install",
    "fleet.scrape": "per peer scrape attempt by the fleet aggregator (peer-loss drills)",
    "trainer.drain": "per refit's labeled-traffic drain by the online trainer",
    "trainer.refit": "per bounded update epoch run by the online trainer",
    "trainer.validate": "per candidate validation pass by the online trainer",
    "trainer.publish": "per candidate publish (swap + checkpoint) by the online trainer",
    "residency.restore": "per tenant AOT restore inside the residency manager",
    "residency.demote_persist": "before the demote-path save_executables persist",
    "aot.load": "per bucket executable read inside restore_executables",
    "fleet.dispatch": "per drained request dispatched by the tenant fleet",
    "wfq.pop": "per weighted-fair-queue pop (request stays queued on fault)",
    "budget.refit": "per refit-budget decision (refit_allowed)",
}

ACTIONS = ("error", "transient", "poison", "shard", "kill", "delay")


class FaultError(RuntimeError):
    """Base class of every injected failure (``transient`` says whether
    the serving retry policy may retry it)."""

    transient = False


class FaultInjected(FaultError):
    """A permanent injected failure."""


class TransientFault(FaultError):
    """An injected failure the batcher's bounded retry may absorb."""

    transient = True


class PoisonedRequest(FaultError):
    """A marked request's forward failure — bisection isolates it so it
    fails alone instead of failing its whole coalesced batch."""


class ShardFault(FaultError):
    """One mesh serving shard failed; carries ``shard`` (its index on
    the replica axis)."""

    def __init__(self, message: str, shard: int = 0):
        super().__init__(message)
        self.shard = int(shard)


class SimulatedKill(FaultError):
    """A simulated process kill at an I/O step (torn-write drills)."""


class FaultSpec:
    """One armed fault: a site, a trigger rule, and an action."""

    __slots__ = ("site", "action", "at", "every", "p", "times",
                 "shard", "delay_ms", "tenant", "message")

    def __init__(
        self,
        site: str,
        action: str = "error",
        *,
        at: Iterable[int] | None = None,
        every: int | None = None,
        p: float | None = None,
        times: int | None = None,
        shard: int = 0,
        delay_ms: float = 0.0,
        tenant: str | None = None,
        message: str | None = None,
    ):
        if site not in SITES:
            raise ValueError(
                f"unknown injection site {site!r}; known: {sorted(SITES)}"
            )
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; known: {ACTIONS}"
            )
        if action == "poison" and site != "batcher.submit":
            raise ValueError(
                "action 'poison' marks requests at admission; arm it on "
                "site 'batcher.submit'"
            )
        if at is None and every is None and p is None:
            raise ValueError(
                "spec needs a trigger: at=[hit indices], every=N, or p="
            )
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.site = site
        self.action = action
        self.at = frozenset(int(i) for i in at) if at is not None else None
        self.every = int(every) if every is not None else None
        self.p = float(p) if p is not None else None
        self.times = int(times) if times is not None else None
        self.shard = int(shard)
        self.delay_ms = float(delay_ms)
        self.tenant = str(tenant) if tenant is not None else None
        self.message = message or f"injected {action} at {site}"

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"site": self.site, "action": self.action}
        if self.at is not None:
            d["at"] = sorted(self.at)
        if self.every is not None:
            d["every"] = self.every
        if self.p is not None:
            d["p"] = self.p
        if self.times is not None:
            d["times"] = self.times
        if self.action == "shard":
            d["shard"] = self.shard
        if self.action == "delay":
            d["delay_ms"] = self.delay_ms
        if self.tenant is not None:
            d["tenant"] = self.tenant
        d["message"] = self.message
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultSpec":
        known = {"site", "action", "at", "every", "p", "times", "shard",
                 "delay_ms", "tenant", "message"}
        unknown = set(d) - known
        if unknown:
            # a typo'd key silently arming nothing would make a chaos
            # suite pass while testing nothing — reject loudly
            raise ValueError(
                f"unknown fault-spec keys {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        return cls(d["site"], d.get("action", "error"),
                   at=d.get("at"), every=d.get("every"), p=d.get("p"),
                   times=d.get("times"), shard=d.get("shard", 0),
                   delay_ms=d.get("delay_ms", 0.0),
                   tenant=d.get("tenant"),
                   message=d.get("message"))


# sbt-lint: shared-state
class FaultPlan:
    """A seeded, armable schedule of :class:`FaultSpec` entries.

    All mutable state (per-site hit counters, per-spec fire counts and
    RNG streams) lives behind one lock that is only ever taken while a
    plan is armed — the unarmed process never reaches it. A plan is
    single-use state-wise: re-running an experiment constructs a fresh
    plan from the same dict/seed (``FaultPlan.from_dict``), which is
    what makes repeat runs byte-identical.
    """

    def __init__(self, specs: Iterable[FaultSpec | dict], *,
                 seed: int = 0, name: str = "custom"):
        self.specs: tuple[FaultSpec, ...] = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
            for s in specs
        )
        if not self.specs:
            raise ValueError("a fault plan needs at least one spec")
        self.seed = int(seed)
        self.name = str(name)
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        #: per-(site, tenant) hit counters — only populated when a probe
        #: passes ``tenant=`` info, which is what tenant-scoped specs
        #: index their ``at``/``every`` triggers against
        self._tenant_hits: dict[tuple[str, str], int] = {}
        self._fires: list[int] = [0] * len(self.specs)
        # one seeded stream per p-spec: probabilistic faults are a pure
        # function of (plan seed, site, spec index, hit sequence)
        self._rngs: list[random.Random | None] = [
            random.Random(
                int.from_bytes(
                    hashlib.sha256(
                        f"{self.seed}|{s.site}|{i}".encode()
                    ).digest()[:8],
                    "big",
                )
            ) if s.p is not None else None
            for i, s in enumerate(self.specs)
        ]
        self._by_site: dict[str, list[int]] = {}
        for i, s in enumerate(self.specs):
            self._by_site.setdefault(s.site, []).append(i)

    # -- the probe -----------------------------------------------------

    def fire(self, site: str, **info: Any) -> bool:
        """Record one hit of ``site`` and run whatever specs trigger.

        Returns True iff a ``poison`` (mark) spec fired; error-class
        actions raise their fault, ``delay`` sleeps. Only ever called
        through the module-level :func:`fire` while this plan is armed.
        """
        marked = False
        action: tuple[FaultSpec, int] | None = None
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            tenant = info.get("tenant")
            thit = 0
            if tenant is not None:
                tkey = (site, str(tenant))
                thit = self._tenant_hits.get(tkey, 0) + 1
                self._tenant_hits[tkey] = thit
            for i in self._by_site.get(site, ()):
                spec = self.specs[i]
                if spec.tenant is not None:
                    # tenant-scoped spec: only this tenant's hits count,
                    # and trigger indices run on its private counter
                    if tenant is None or str(tenant) != spec.tenant:
                        continue
                    idx = thit
                else:
                    idx = hit
                if spec.times is not None and self._fires[i] >= spec.times:
                    continue
                due = False
                if spec.at is not None and idx in spec.at:
                    due = True
                if not due and spec.every is not None \
                        and idx % spec.every == 0:
                    due = True
                if not due and spec.p is not None:
                    # draw exactly once per hit so the stream position
                    # is a pure function of the hit count
                    due = self._rngs[i].random() < spec.p
                if not due:
                    continue
                self._fires[i] += 1
                if spec.action == "poison":
                    marked = True
                else:
                    action = (spec, idx)
                    break
        if action is None:
            if marked:
                self._count(site, "poison")
            return marked
        spec, hit = action
        self._count(site, spec.action)
        msg = f"{spec.message} (hit {hit})"
        if spec.action == "delay":
            time.sleep(spec.delay_ms / 1e3)
            return marked
        if spec.action == "transient":
            raise TransientFault(msg)
        if spec.action == "shard":
            raise ShardFault(msg, shard=spec.shard)
        if spec.action == "kill":
            raise SimulatedKill(msg)
        raise FaultInjected(msg)

    @staticmethod
    def _count(site: str, action: str) -> None:
        telemetry.inc("sbt_faults_injected_total",
                      labels={"site": site, "action": action})
        telemetry.emit_event({
            "kind": "fault_injected", "site": site, "action": action,
        })

    # -- identity / reporting ------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema": PLAN_SCHEMA_VERSION,
            "name": self.name,
            "seed": self.seed,
            "faults": [s.to_dict() for s in self.specs],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultPlan":
        schema = d.get("schema", PLAN_SCHEMA_VERSION)
        if schema > PLAN_SCHEMA_VERSION:
            raise ValueError(
                f"fault plan schema {schema} is newer than supported "
                f"({PLAN_SCHEMA_VERSION})"
            )
        return cls(d.get("faults", ()), seed=d.get("seed", 0),
                   name=d.get("name", "custom"))

    def digest(self) -> str:
        """sha256 of the canonical plan JSON — the identity a chaos
        report records so two runs are comparable only when they armed
        the same schedule."""
        return hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()
        ).hexdigest()

    def snapshot(self) -> dict[str, Any]:
        """Hits and fires per site (plus per-spec fire counts) — the
        deterministic transcript a chaos replay asserts across
        repeats."""
        with self._lock:
            hits = dict(sorted(self._hits.items()))
            tenant_hits = {
                f"{site}|{tenant}": n
                for (site, tenant), n in sorted(self._tenant_hits.items())
            }
            fires = list(self._fires)
        by_site: dict[str, int] = {}
        for i, s in enumerate(self.specs):
            by_site[s.site] = by_site.get(s.site, 0) + fires[i]
        snap = {
            "name": self.name,
            "seed": self.seed,
            "hits": hits,
            "fires": {k: v for k, v in sorted(by_site.items()) if v},
            "fired_total": sum(fires),
        }
        if tenant_hits:
            # only present when some probe passed tenant info, so the
            # committed digests of tenant-blind chaos drills are stable
            snap["tenant_hits"] = tenant_hits
        return snap

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))


# -- module-level arming ------------------------------------------------

#: the armed plan, or None. Hot-path probes read THIS attribute and do
#: nothing else when it is None — the zero-overhead-when-unarmed
#: contract (no lock, no call, no allocation).
ACTIVE: FaultPlan | None = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide (replacing any armed plan)."""
    global ACTIVE
    ACTIVE = plan
    telemetry.set_gauge("sbt_faults_armed", 1.0)
    return plan


def disarm() -> None:
    global ACTIVE
    ACTIVE = None
    telemetry.set_gauge("sbt_faults_armed", 0.0)


def active() -> FaultPlan | None:
    return ACTIVE


class armed:
    """``with faults.armed(plan): ...`` — arm for a scope, always
    disarm on exit (chaos experiments must never leak into the tests
    that run after them)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return arm(self.plan)

    def __exit__(self, *exc) -> None:
        disarm()


def fire(site: str, **info: Any) -> bool:
    """The probe body: no-op unless a plan is armed. Hot paths gate the
    CALL itself on ``faults.ACTIVE is not None`` so the unarmed cost is
    one attribute read; cold paths may call this directly."""
    plan = ACTIVE
    if plan is None:
        return False
    return plan.fire(site, **info)


# -- builtin scenario library -------------------------------------------

def builtin_plan_spec(name: str, seed: int = 0) -> dict[str, Any]:
    """Named chaos scenarios as plan dicts — the JAX package's library,
    with the same names, specs and seeds, so one named drill arms the
    same schedule in either package. A fresh :class:`FaultPlan` is
    constructed per run so repeats start from hit zero.

    - ``blips``: transient forward failures the bounded retry absorbs;
    - ``poison``: marked requests whose batches bisect down to the one
      bad request;
    - ``mixed``: blips + poison together (the default chaos drill);
    - ``shard-loss``: one mesh shard fails mid-traffic and serving
      degrades to the surviving-replica aggregate;
    - ``worker-crash``: the batcher worker dies and the supervisor
      restarts it;
    - ``crash-loop``: enough worker crashes inside the window to trip
      degraded reject mode;
    - ``peer-loss``: one fleet peer's scrapes fail for a stretch and
      recover — the aggregator marks it stale (excluded from merge and
      quorum, never merged as zeros), fleet health degrades, then
      heals. Tuned for a 3-peer fleet scraped in construction order
      (``every=3`` lands on the last peer each tick; ``times=20``
      bounds the outage);
    - ``tenant-chaos``: a mixed plan aimed at one tenant (``t1``) of a
      multi-tenant fleet — three consecutive dispatch failures trip its
      quarantine, and its first post-recovery restore hits a corrupt
      bucket read.

    ``shard-loss`` fires at ``executor.mesh_forward``, the probe of a
    mesh executor's slab forward. In ``tenant-chaos`` the ``fleet.dispatch`` spec fires
    (``tenancy/fleet.py``); its ``aot.load`` spec stays a definition that
    never fires — the port has no persisted executable cache to read (a
    CUDA graph cannot be serialized; a restore re-captures). The worker
    drills need a THREADED batcher (a stepped batcher has no worker,
    where ``batcher.worker`` can never fire).
    """
    plans: dict[str, list[dict[str, Any]]] = {
        "blips": [
            {"site": "batcher.batch_forward", "action": "transient",
             "every": 7, "times": 4},
        ],
        "poison": [
            {"site": "batcher.submit", "action": "poison",
             "at": [5, 23]},
        ],
        "mixed": [
            {"site": "batcher.batch_forward", "action": "transient",
             "every": 11, "times": 3},
            {"site": "batcher.submit", "action": "poison",
             "at": [5, 23]},
        ],
        "shard-loss": [
            {"site": "executor.mesh_forward", "action": "shard",
             "at": [4], "shard": 1},
        ],
        "worker-crash": [
            {"site": "batcher.worker", "action": "error", "at": [3]},
        ],
        "crash-loop": [
            {"site": "batcher.worker", "action": "error",
             "every": 1, "times": 10},
        ],
        "peer-loss": [
            {"site": "fleet.scrape", "action": "error",
             "every": 3, "times": 20},
        ],
        "tenant-chaos": [
            {"site": "fleet.dispatch", "action": "error",
             "tenant": "t1", "at": [2, 3, 4]},
            {"site": "aot.load", "action": "error",
             "tenant": "t1", "at": [1]},
        ],
    }
    if name not in plans:
        raise ValueError(
            f"unknown builtin chaos plan {name!r}; known: "
            f"{sorted(plans)} (or pass a plan JSON path)"
        )
    return {"schema": PLAN_SCHEMA_VERSION, "name": name, "seed": seed,
            "faults": plans[name]}


def builtin_plan(name: str, seed: int = 0) -> FaultPlan:
    return FaultPlan.from_dict(builtin_plan_spec(name, seed))
