"""Tenant contracts: the named endpoint spec the whole plane keys on.

A ``TenantSpec`` is everything the fleet needs to know about one
endpoint that the model itself cannot tell it: how important its
traffic is relative to the others (priority class — the admission
controller's shed order under overload), what share of the device it
is entitled to when everyone is saturated (WFQ weight), what it is
allowed to consume in absolute terms (rps/row quotas — token-bucket
enforced), and how much of the fleet's refit compute its online
trainer may claim (refit weight). Specs are frozen: the fleet's
decisions must be a pure function of (workload, specs, seed), and a
mutable spec would be a hidden clock.

The port's copy of the JAX package's ``tenancy/spec.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: shed order under pressure: higher level sheds FIRST. Interactive
#: traffic is never admission-shed for priority (only quota / the
#: batcher's own backpressure can reject it).
PRIORITY_CLASSES = ("interactive", "standard", "batch")
PRIORITY_LEVEL = {name: i for i, name in enumerate(PRIORITY_CLASSES)}


@dataclass(frozen=True)
class TenantSpec:
    """One named serving endpoint's fleet contract.

    ``name`` is the registry model name the tenant serves under.
    ``weight`` is the WFQ share (relative, > 0): under saturation a
    tenant's served rows are proportional to its weight. ``quota_rps``
    / ``quota_rows_ps`` are absolute admission ceilings (None =
    unmetered) enforced by a deterministic token bucket on the
    injected clock. ``refit_weight`` (defaults to ``weight``) is the
    tenant's share of the fleet refit budget
    (:class:`~spark_bagging_tpu_torch.tenancy.budget.RefitBudgeter`).
    """

    name: str
    priority: str = "standard"
    weight: float = 1.0
    quota_rps: float | None = None
    quota_rows_ps: float | None = None
    refit_weight: float | None = None
    #: free-form operator annotations (team, SLO doc link, ...)
    labels: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("TenantSpec needs a non-empty name")
        if self.priority not in PRIORITY_LEVEL:
            raise ValueError(
                f"unknown priority {self.priority!r}; expected one of "
                f"{PRIORITY_CLASSES}"
            )
        if not self.weight > 0:
            raise ValueError(
                f"weight must be > 0, got {self.weight}"
            )
        for attr in ("quota_rps", "quota_rows_ps", "refit_weight"):
            v = getattr(self, attr)
            if v is not None and not v > 0:
                raise ValueError(
                    f"{attr} must be > 0 or None, got {v}"
                )

    @property
    def priority_level(self) -> int:
        return PRIORITY_LEVEL[self.priority]

    @property
    def effective_refit_weight(self) -> float:
        return (self.weight if self.refit_weight is None
                else self.refit_weight)

    def to_dict(self) -> dict:
        """Deterministic report row (``/debug/tenancy``)."""
        return {
            "name": self.name,
            "priority": self.priority,
            "weight": self.weight,
            "quota_rps": self.quota_rps,
            "quota_rows_ps": self.quota_rows_ps,
            "refit_weight": self.effective_refit_weight,
        }
