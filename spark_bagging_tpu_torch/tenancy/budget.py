"""Per-tenant online-refit budgeting: fair compute for the tail.

The online plane (``online/trainer.py``) retrains any model whose drift
alerts fire —
which at fleet scale means the hottest, driftiest tenant can consume
every refit cycle while twenty tail tenants quietly never retrain.
The budgeter is the admission controller's sibling for REFIT compute:
a deterministic per-window allocation proportional to each tenant's
``refit_weight`` (arxiv 1312.5021's budgeted online bootstrap,
applied across tenants instead of within one learner's replicas).

Mechanics: time is divided into fixed windows on the caller-passed
clock (virtual in the replay drill — no wall reads). Each window,
tenant *t* may start ``ceil(total × w_t / Σw)`` refits, minimum one —
a tail tenant's entitlement never rounds to zero, which is the whole
anti-starvation point. ``allow()`` is the decision seam the
``OnlineTrainer`` consults at trigger time (its ``refit_budget=``
hook): denials are counted per tenant
(``sbt_tenancy_refit_denied_total{tenant=}``) and the trigger is
dropped, not deferred — the next drift alert re-triggers, and by then
the window may have turned.

The port's copy of the JAX package's ``tenancy/budget.py``; a refit it
allows runs the fit's kernels on the card (the logistic learner's
scaled-Gram kernel, ``ops/gram.py``).
"""

from __future__ import annotations

import math
from typing import Iterable

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.tenancy.spec import TenantSpec


# sbt-lint: shared-state
class RefitBudgeter:
    """Windowed, weight-proportional refit allowances per tenant."""

    def __init__(
        self,
        specs: Iterable[TenantSpec],
        *,
        total_per_window: int = 4,
        window_s: float = 60.0,
    ) -> None:
        if total_per_window < 1:
            raise ValueError(
                f"total_per_window must be >= 1, got {total_per_window}"
            )
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.total_per_window = int(total_per_window)
        self.window_s = float(window_s)
        self._lock = make_lock("tenancy.budget")
        specs = list(specs)
        if not specs:
            raise ValueError("RefitBudgeter needs at least one tenant")
        self._specs: dict[str, TenantSpec] = {s.name: s for s in specs}
        #: tenants whose budget has been released back to the pool
        #: (quarantined) — quota 0 until readmitted
        self._released: set[str] = set()
        self._quota: dict[str, int] = {}
        self._recompute_locked()
        self._window_start: float | None = None
        self._used: dict[str, int] = {}
        self._allowed: dict[str, int] = {}
        self._denied: dict[str, int] = {}

    def _recompute_locked(self) -> None:
        """Reallocate the window total over non-released tenants,
        weight-proportional with the floor-of-1 anti-starvation rule;
        released tenants hold quota 0 (their share flows to the pool)."""
        live = [s for n, s in sorted(self._specs.items())
                if n not in self._released]
        quota = {n: 0 for n in self._specs}
        if live:
            weight_sum = sum(s.effective_refit_weight for s in live)
            for s in live:
                #: floor of 1: the tail must never be rounded out of
                #: retraining entirely
                quota[s.name] = max(1, math.ceil(
                    self.total_per_window
                    * s.effective_refit_weight / weight_sum))
        # sbt-lint: disable=shared-state-unlocked — _locked helper: callers hold self._lock (or run pre-publication in __init__)
        self._quota = quota

    def quota(self, name: str) -> int:
        try:
            return self._quota[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; have {sorted(self._quota)}"
            ) from None

    def allow(self, name: str, now: float) -> bool:
        """May ``name`` start a refit at ``now``? Deterministic:
        windows are ``[start, start + window_s)`` anchored at the
        first decision's clock, and allowances reset at each turn."""
        if faults.ACTIVE is not None:
            faults.fire("budget.refit", tenant=name)
        with self._lock:
            quota = self._quota.get(name)
            if quota is None:
                raise KeyError(
                    f"unknown tenant {name!r}; have "
                    f"{sorted(self._quota)}"
                )
            if (self._window_start is None
                    or now - self._window_start >= self.window_s):
                self._window_start = float(now)
                self._used = {}
            used = self._used.get(name, 0)
            ok = used < quota
            if ok:
                self._used[name] = used + 1
                self._allowed[name] = self._allowed.get(name, 0) + 1
            else:
                self._denied[name] = self._denied.get(name, 0) + 1
        if not ok:
            telemetry.inc("sbt_tenancy_refit_denied_total",
                          labels={"tenant": name})
        return ok

    def release(self, name: str) -> None:
        """Return ``name``'s refit entitlement to the pool (quarantine
        trip): its quota drops to 0 and every surviving tenant's share
        is recomputed over the remaining weight mass. Idempotent."""
        with self._lock:
            if name not in self._specs:
                raise KeyError(
                    f"unknown tenant {name!r}; have "
                    f"{sorted(self._specs)}"
                )
            if name in self._released:
                return
            self._released.add(name)
            self._recompute_locked()

    def readmit(self, name: str) -> None:
        """Undo :meth:`release` after quarantine recovery. Idempotent."""
        with self._lock:
            if name not in self._specs:
                raise KeyError(
                    f"unknown tenant {name!r}; have "
                    f"{sorted(self._specs)}"
                )
            if name not in self._released:
                return
            self._released.discard(name)
            self._recompute_locked()

    def for_tenant(self, name: str):
        """A zero-arg-style hook bound to one tenant — the exact shape
        ``OnlineTrainer(refit_budget=...)`` consumes: called with the
        trigger's clock, returns the decision."""
        self.quota(name)  # fail fast on unknown tenants
        return lambda now: self.allow(name, now)

    def counts(self) -> dict[str, dict[str, int]]:
        """{"allowed"|"denied": {tenant: n}} — transcript-ready."""
        with self._lock:
            return {
                "allowed": dict(sorted(self._allowed.items())),
                "denied": dict(sorted(self._denied.items())),
            }

    def state(self) -> dict:
        with self._lock:
            return {
                "total_per_window": self.total_per_window,
                "window_s": self.window_s,
                "quota": dict(sorted(self._quota.items())),
                "released": sorted(self._released),
                "window_used": dict(sorted(self._used.items())),
                "allowed": dict(sorted(self._allowed.items())),
                "denied": dict(sorted(self._denied.items())),
            }
