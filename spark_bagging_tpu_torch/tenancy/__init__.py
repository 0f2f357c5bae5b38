"""Tenancy plane — multi-tenant fleet serving on one card.

One process, many living models: a Zipf-popular fleet where a handful
of tenants carry most of the traffic and a long tail must neither
starve nor crowd the hot set out of device memory. This package
generalizes the single-model ``ModelRegistry`` + ``MicroBatcher`` pair
into that fleet plane, built from four enforcement pieces that all ride
the replay/digest discipline (every decision a pure function of
(workload, seed) under an injected virtual clock):

- :class:`~spark_bagging_tpu_torch.tenancy.spec.TenantSpec` — the named
  endpoint contract: priority class, WFQ weight, rps/row quotas,
  refit weight.
- :class:`~spark_bagging_tpu_torch.tenancy.admission.AdmissionController`
  — turns the batcher's ``Overloaded`` backpressure into an
  enforcement point: deterministic token-bucket quotas, and a
  pressure state machine that sheds low-priority classes first when
  the device is overloaded (counted per tenant + reason).
- :class:`~spark_bagging_tpu_torch.tenancy.wfq.WFQScheduler` — virtual-
  finish-time weighted fair queuing across tenants sharing a device;
  batch composition is the pop order, a pure function of the
  enqueue stream.
- :class:`~spark_bagging_tpu_torch.tenancy.residency.ResidencyManager` —
  demand-driven residency over an executor fleet larger than what
  stays captured: cold tenants are demoted (their CUDA graphs and pool
  segments released, their program-cache entries dropped through the
  capacity plane) and restored on first hit by re-capturing the
  recorded ladder — counted, never wrong answers; hot tenants are
  pinned via the capacity plane's demand classes.
- :class:`~spark_bagging_tpu_torch.tenancy.budget.RefitBudgeter` — per-
  tenant online-refit budgeting so one drifting hot tenant cannot
  starve the tail's refit compute (arxiv 1312.5021's budgeted
  online bootstrap, applied fleet-wide).

:class:`~spark_bagging_tpu_torch.tenancy.fleet.TenantFleet` composes
them over one registry — plus a
:class:`~spark_bagging_tpu_torch.tenancy.fleet.QuarantineMachine` that
contains a failing tenant's blast radius (requests shed with
:class:`~spark_bagging_tpu_torch.tenancy.admission.TenantQuarantined`,
seeded-backoff single-probe recovery) without touching its neighbours.
``install()`` publishes a fleet for the telemetry server's
``/debug/tenancy`` route.

The port's copy of the JAX package's ``tenancy/``: the same names and
policy transcripts. Where the JAX package persists a demoted tenant's
executables and restores them without a recompile, the port re-captures
the tenant's ladder on restore (a CUDA graph cannot be serialized; see
``tenancy/residency.py``).
"""

from __future__ import annotations

from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.tenancy.admission import (
    AdmissionController,
    AdmissionShed,
    QuotaExceeded,
    TenantQuarantined,
)
from spark_bagging_tpu_torch.tenancy.budget import RefitBudgeter
from spark_bagging_tpu_torch.tenancy.fleet import QuarantineMachine, TenantFleet
from spark_bagging_tpu_torch.tenancy.residency import ResidencyManager
from spark_bagging_tpu_torch.tenancy.spec import (
    PRIORITY_CLASSES,
    PRIORITY_LEVEL,
    TenantSpec,
)
from spark_bagging_tpu_torch.tenancy.wfq import WFQScheduler

__all__ = [
    "PRIORITY_CLASSES",
    "PRIORITY_LEVEL",
    "AdmissionController",
    "AdmissionShed",
    "QuarantineMachine",
    "QuotaExceeded",
    "RefitBudgeter",
    "ResidencyManager",
    "TenantFleet",
    "TenantQuarantined",
    "TenantSpec",
    "WFQScheduler",
    "get",
    "install",
    "uninstall",
]

# -- process-default fleet (the /debug/tenancy seam) -------------------
# Mirrors telemetry.alerts' default-engine seam: a serving process
# installs its fleet once; the exposition server reads it at request
# time without importing this package eagerly.

_default_lock = make_lock("tenancy.default")
_default_fleet: TenantFleet | None = None


def install(fleet: TenantFleet) -> TenantFleet:
    """Publish ``fleet`` as the process default (``/debug/tenancy``)."""
    global _default_fleet
    with _default_lock:
        _default_fleet = fleet
    return fleet


def get() -> TenantFleet | None:
    with _default_lock:
        return _default_fleet


def uninstall() -> None:
    global _default_fleet
    with _default_lock:
        _default_fleet = None
