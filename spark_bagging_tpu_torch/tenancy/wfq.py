"""Deterministic weighted fair queuing (virtual finish times).

Tenants sharing one device must split its forward capacity by WEIGHT,
not by arrival luck — otherwise the Zipf head simply outqueues the
tail. The scheduler is self-clocked fair queuing (SCFQ, Golestani
'94): each enqueued request gets a virtual **finish tag**

    start  = max(v, finish[tenant])          # v = scheduler virtual time
    finish = start + cost / weight[tenant]

where ``cost`` is the request's row count, and service order is
ascending finish tag. The virtual clock ``v`` advances to the finish
tag of the request being served — no wall clock anywhere, so the pop
order (and therefore DOWNSTREAM BATCH COMPOSITION — the fleet submits
to per-tenant batchers in pop order) is a pure function of the
enqueue sequence. Ties break on (tenant name, arrival sequence):
total order, replay-stable.

Why this shape: under saturation each backlogged tenant's served rows
grow proportionally to its weight (the classic SCFQ fairness bound —
tested as an invariant in tests/test_tenancy.py), an idle tenant's
unused share is redistributed automatically (its finish tags lag
``v``, so its next arrival starts at ``v``, not in the past), and no
backlogged tenant starves: every enqueue gets a finite finish tag and
tags ahead of it are finitely many.

The structure is intentionally NOT thread-safe-free-running: the
fleet drives it under its own lock at window boundaries (enqueue the
window, drain in order), matching the stepped-batcher replay
discipline.

The port's copy of the JAX package's ``tenancy/wfq.py``.
"""

from __future__ import annotations

import heapq
from typing import Any, Iterator

from spark_bagging_tpu_torch import faults


class WFQScheduler:
    """Virtual-finish-time fair queue over named tenants."""

    def __init__(self, weights: dict[str, float]):
        if not weights:
            raise ValueError("WFQScheduler needs at least one tenant")
        for name, w in weights.items():
            if not w > 0:
                raise ValueError(
                    f"weight for {name!r} must be > 0, got {w}"
                )
        self._weights = {str(k): float(v) for k, v in weights.items()}
        #: per-tenant last assigned finish tag
        self._finish: dict[str, float] = {t: 0.0 for t in self._weights}
        self._vtime = 0.0
        self._seq = 0
        #: (finish, tenant, seq, cost, item)
        self._heap: list[tuple[float, str, int, float, Any]] = []
        #: cumulative rows handed to service, per tenant (fairness audit)
        self._served: dict[str, float] = {t: 0.0 for t in self._weights}

    def __len__(self) -> int:
        return len(self._heap)

    @property
    def vtime(self) -> float:
        return self._vtime

    def head_tenant(self) -> str | None:
        """The tenant whose request would pop next (None when empty) —
        the fleet's attribution handle when the pop itself faults."""
        return self._heap[0][1] if self._heap else None

    def enqueue(self, tenant: str, item: Any, cost: float = 1.0) -> float:
        """Tag and queue one request; returns its finish tag.

        ``cost`` is the service demand (rows for serving traffic);
        heavier requests push the tenant's next tag further out, which
        is what makes the shares ROW-proportional, not
        request-proportional."""
        try:
            weight = self._weights[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r}; have "
                f"{sorted(self._weights)}"
            ) from None
        if not cost > 0:
            raise ValueError(f"cost must be > 0, got {cost}")
        start = max(self._vtime, self._finish[tenant])
        finish = start + float(cost) / weight
        self._finish[tenant] = finish
        self._seq += 1
        heapq.heappush(self._heap,
                       (finish, tenant, self._seq, float(cost), item))
        return finish

    def pop(self) -> tuple[str, Any]:
        """Next (tenant, item) in fair order; advances virtual time."""
        if not self._heap:
            raise IndexError("pop from an empty WFQScheduler")
        if faults.ACTIVE is not None:
            # probe BEFORE the heap mutation: an injected pop fault
            # leaves the head request queued, so containment never
            # silently drops a request
            faults.fire("wfq.pop", tenant=self._heap[0][1])
        finish, tenant, _seq, cost, item = heapq.heappop(self._heap)
        # self-clocking: v jumps to the tag in service, so a tenant
        # that idled cannot bank credit from the past
        self._vtime = finish
        self._served[tenant] += cost
        return tenant, item

    def drain(self) -> Iterator[tuple[str, Any]]:
        """Pop everything queued, in fair order."""
        while self._heap:
            yield self.pop()

    def service_totals(self) -> dict[str, float]:
        """Cumulative cost handed to service per tenant, name-sorted —
        the fairness-invariant audit surface (and transcript field)."""
        return {t: self._served[t] for t in sorted(self._served)}

    def backlog(self) -> dict[str, int]:
        """Queued request count per tenant (name-sorted)."""
        out = {t: 0 for t in sorted(self._weights)}
        for _f, tenant, _s, _c, _i in self._heap:
            out[tenant] += 1
        return out

    def state(self) -> dict:
        return {
            "vtime": self._vtime,
            "queued": len(self._heap),
            "weights": {t: self._weights[t]
                        for t in sorted(self._weights)},
            "served_cost": self.service_totals(),
            "backlog": self.backlog(),
        }
