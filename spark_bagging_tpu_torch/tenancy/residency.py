"""Demand-driven residency: which tenants keep their CUDA graphs captured.

A fleet of many registered models cannot keep every bucket ladder
captured: executors hold their bucket programs in-instance (the unified
program cache is a dedup/metering layer that holds them weakly, not the
owner — see ``serving/program_cache.py``), so enforcing a residency
budget means acting on the EXECUTORS. On the card each resident bag
holds one CUDA-graph pool (its captures' segments plus the static
buffers), so this policy decides where device memory is spent. The
manager runs an enforced LRU over tenants with two demand-aware twists,
both fed by the capacity plane's hot/warm/cold classification:

- **Hot tenants are pinned.** Victim selection walks LRU order but
  skips tenants the plane currently classifies ``"hot"``; only when
  EVERY candidate is hot does it fall back to strict LRU, counting
  ``sbt_tenancy_pin_violations_total{tenant=}`` — the capacity signal
  that the residency budget itself is undersized.
- **Demotion is never destructive.** A demoted tenant's programs are
  released (``EnsembleExecutor.release_programs``: its graphs and their
  pool segments free, and its unified-cache entries are dropped,
  charged through the capacity plane's eviction seam so the ledger
  stays reconciled). The ladder it held is recorded — with the quality
  tap's per-replica ladder when a monitor is attached. The tenant keeps
  serving: its first hit after demotion re-captures exactly that
  ladder (``sbt_tenancy_restores_total{tenant=}``) — a counted
  round-trip, never a wrong answer.

The port's copy of the JAX package's ``tenancy/residency.py``, with one
deliberate difference. There a demoted tenant's executables are
persisted to a per-tenant AOT directory and a restore reloads them: it
never recompiles. A CUDA graph cannot be serialized, so here nothing is
persisted and a restore RE-CAPTURES its recorded ladder (through
``EnsembleExecutor.warmup``, never ``restore_executables``, which
counts a persisted-cache miss). The captures count in
``sbt_serving_compiles_total`` (the tap's in
``sbt_quality_disagreement_compiles_total``), and the invariant
becomes: no capture on a request's forward path, and every capture
after warm-up belongs to a restore's ladder. ``aot_root`` and
:meth:`ResidencyManager.tenant_dir` keep the JAX package's validation,
so a caller's code runs unchanged; nothing is written there. A demotion
of a CUDA executor ends with ``torch.cuda.empty_cache()``: its released
graphs' private pool can never be captured into again (the executor
takes a fresh pool), and its segments return to the device only there —
without it the card's reserved bytes grew by about the pool at every
demote/restore round trip.

Every transition is recorded in a monotonic in-object event log
(kind/tenant/seq) — the residency transcript the replay drill
digests; byte-identical across repeats because nothing here reads a
clock.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable

import torch

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.telemetry import capacity as _capacity


def cache_pin_policy(
    plane: Any = None,
) -> Callable[[str], bool]:
    """A ``ProgramCache`` pin policy: an entry is pinned iff its
    fingerprint's committed owner is currently classified ``"hot"``
    by ``plane`` (default: the armed capacity plane at decision
    time). Unowned fingerprints are never pinned."""

    def pinned(fingerprint: str) -> bool:
        p = plane if plane is not None else _capacity.ACTIVE
        if p is None:
            return False
        owner = p.owner_label(fingerprint)
        if owner is None:
            return False
        return p.demand_class(owner) == "hot"

    return pinned


# sbt-lint: shared-state
class ResidencyManager:
    """Enforced tenant LRU with demand-aware pinning over one registry.

    ``capacity`` bounds how many tenants keep captured programs;
    ``aot_root`` is the JAX package's root of per-tenant AOT
    directories, validated and never written (see the module
    docstring). ``plane`` pins hot tenants (None = read the armed plane
    per decision).

    Lock order: residency → registry → executor → program cache; this
    lock is held across demote/restore so transitions serialize, and
    nothing downstream ever calls back into residency (the acyclic
    edge set the lock-order detector checks in tests).
    """

    def __init__(
        self,
        registry: Any,
        *,
        capacity: int,
        aot_root: str,
        plane: Any = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.registry = registry
        self.capacity = int(capacity)
        self.aot_root = str(aot_root)
        self._plane = plane
        self._lock = make_lock("tenancy.residency")
        #: resident tenant names, LRU-first
        self._resident: OrderedDict[str, bool] = OrderedDict()
        #: demoted tenant -> (serving buckets, tap buckets) released at
        #: its demotion: the ladder its restore re-captures
        self._ladders: dict[str, tuple[tuple[int, ...],
                                       tuple[int, ...]]] = {}
        self._events: list[dict] = []
        self._seq = 0
        self._demotions: dict[str, int] = {}
        self._restores: dict[str, int] = {}
        self._pin_violations: dict[str, int] = {}

    # -- plumbing -------------------------------------------------------

    def tenant_dir(self, name: str) -> str:
        if os.sep in name or (os.altsep and os.altsep in name):
            raise ValueError(
                f"tenant name {name!r} is not a safe directory name"
            )
        return os.path.join(self.aot_root, name)

    def _plane_now(self) -> Any:
        return self._plane if self._plane is not None else _capacity.ACTIVE

    def _event(self, kind: str, tenant: str, **extra: Any) -> None:
        # sbt-lint: disable=shared-state-unlocked — _locked-path helper, every caller holds self._lock
        self._seq += 1
        self._events.append({"kind": kind, "tenant": tenant,
                             "seq": self._seq, **extra})

    # -- transitions ----------------------------------------------------

    def adopt(self, name: str) -> None:
        """Mark a freshly registered (warmed) tenant resident and
        enforce the budget. Idempotent: re-adopting bumps LRU."""
        with self._lock:
            self._resident[name] = True
            self._resident.move_to_end(name)
            self._enforce_locked(keep=name)
            self._export_locked()

    def touch(self, name: str) -> str:
        """Serve-path residency check for one tenant's traffic.

        Returns ``"resident"`` (LRU bump only) or ``"restored"`` (the
        counted demote round-trip completing: the recorded ladder
        re-captured, budget re-enforced — some OTHER tenant may demote
        to make room)."""
        with self._lock:
            if name in self._resident:
                self._resident.move_to_end(name)
                return "resident"
            self._restore_locked(name)
            self._resident[name] = True
            self._resident.move_to_end(name)
            self._enforce_locked(keep=name)
            self._export_locked()
            return "restored"

    def evict(self, name: str) -> bool:
        """Force one tenant out of residency NOW (the quarantine trip's
        slot-freeing edge — not a budget decision, so no victim walk
        and no pin check). Demotes through the normal non-destructive
        path; a no-op for tenants that are not resident. Returns
        whether a demotion happened."""
        with self._lock:
            if name not in self._resident:
                return False
            self._demote_locked(name)
            self._export_locked()
            return True

    def _enforce_locked(self, *, keep: str) -> None:
        while len(self._resident) > self.capacity:
            victim = self._pick_victim_locked(keep=keep)
            self._demote_locked(victim)

    def _pick_victim_locked(self, *, keep: str) -> str:
        plane = self._plane_now()
        candidates = [t for t in self._resident if t != keep]
        if plane is not None:
            for t in candidates:
                if plane.demand_class(t) != "hot":
                    return t
        # every candidate is hot (or no plane): strict LRU, counted —
        # the residency budget is smaller than the hot set
        victim = candidates[0]
        if plane is not None:
            # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
            self._pin_violations[victim] = (
                self._pin_violations.get(victim, 0) + 1)
            self._event("pin_violation", victim)
            telemetry.inc("sbt_tenancy_pin_violations_total")
            telemetry.inc("sbt_tenancy_pin_violations_total",
                          labels={"tenant": victim})
        return victim

    def _demote_locked(self, name: str) -> None:
        ex = self.registry.executor(name)
        if ex.compiled_buckets and faults.ACTIVE is not None:
            # the JAX package's persist seam, at the same point: before
            # anything is released, so a kill here leaves the tenant
            # resident with its programs
            faults.fire("residency.demote_persist", tenant=name)
        # the tap's ladder is read before the release clears it
        replica = ex.replica_buckets if ex.quality is not None else ()
        released = ex.release_programs()
        if released and ex.device.type == "cuda":
            # the dead pool's segments back to the device (module doc)
            torch.cuda.empty_cache()
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        self._ladders[name] = (released, replica)
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        del self._resident[name]
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        self._demotions[name] = self._demotions.get(name, 0) + 1
        self._event("demote", name)
        telemetry.inc("sbt_tenancy_demotions_total",
                      labels={"tenant": name})

    def _restore_locked(self, name: str) -> None:
        ex = self.registry.executor(name)
        if faults.ACTIVE is not None:
            faults.fire("residency.restore", tenant=name)
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        buckets, replica = self._ladders.pop(name, ((), ()))
        # re-capture exactly the recorded ladder; a capture that fails
        # raises (a CUDA model is never served eagerly)
        recaptured = ex.warmup(buckets)
        if replica and ex.quality is not None:
            ex.warmup_replica(replica)
        # sbt-lint: disable=shared-state-unlocked — _locked helper, every caller holds self._lock
        self._restores[name] = self._restores.get(name, 0) + 1
        self._event("restore", name, buckets=len(recaptured))
        telemetry.inc("sbt_tenancy_restores_total",
                      labels={"tenant": name})

    def _export_locked(self) -> None:
        telemetry.set_gauge("sbt_tenancy_resident_tenants",
                            float(len(self._resident)))

    # -- reporting ------------------------------------------------------

    def residents(self) -> tuple[str, ...]:
        """Resident tenants, LRU-first (deterministic)."""
        with self._lock:
            return tuple(self._resident)

    def events(self) -> list[dict]:
        """The full transition log (copy), seq-ordered."""
        with self._lock:
            return [dict(e) for e in self._events]

    def counts(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {
                "demotions": dict(sorted(self._demotions.items())),
                "restores": dict(sorted(self._restores.items())),
                "pin_violations": dict(
                    sorted(self._pin_violations.items())),
            }

    def state(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "residents": list(self._resident),
                "events": len(self._events),
                "demotions": dict(sorted(self._demotions.items())),
                "restores": dict(sorted(self._restores.items())),
                "pin_violations": dict(
                    sorted(self._pin_violations.items())),
            }
