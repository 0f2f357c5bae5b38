"""Capacity & residency observability plane.

One process hosting many model versions needs an exact answer to three
questions before any residency policy can exist: what does each
resident model COST (bytes held — params and the captured bucket
programs), what demand JUSTIFIES that cost (per-model request/row
rates, popularity ranks, a hot/warm/cold classification with
hysteresis), and when the program cache evicts, WHOSE bytes went
(owner-attributed eviction accounting plus a decision explainer). This
module is that measurement plane — policy-free by design: it measures
the inputs a residency policy will consume, it decides nothing.

The port's copy of the JAX package's ``telemetry/capacity.py``. Its
structure mirrors the other planes (``telemetry/perf.py``,
``faults.py``): a process-global ``ACTIVE`` attribute that serving hot
paths read ONCE per packed batch (the zero-overhead-unarmed contract),
``enable()``/``disable()`` for users and ``install()`` as a
save/restore seam.

Measurement honesty rules:

- program bytes walk a ladder — a CUDA-graph program's ``nbytes`` (the
  segments its capture added to the executor's graph pool plus its
  static input and output buffers, ``serving/executor.py``), with
  source ``"graph_pool"``, and an explicit ``(None, "unmeasured")``
  bottom (the CPU's eager program holds no device memory of its own).
  An unmeasured entry is surfaced as a flag, never counted as 0 bytes
  of residency.
- ledger sums RECONCILE: grouping the program cache's resident entries
  by owner (plus an ``"(unattributed)"`` bucket for fingerprints no
  registry commit ever claimed) must sum back to the cache's own
  totals, entry-for-entry and byte-for-byte. The cache holds its
  programs weakly, so an entry whose last executor was collected
  leaves the cache's totals and the ledger together.
- ownership is established only at registry COMMIT (register/swap
  success). Cache entries are attributed lazily, at read time, by
  resolving their key's fingerprint through the plane: a failed swap's
  pre-commit captures therefore never produce ledger entries (its
  fingerprint was never registered), while a successful swap's
  pre-commit warm captures become attributed retroactively. A program
  adopted by a second executor of the same weights stays one entry,
  charged to its fingerprint's owner: its bytes live in the pool of
  the executor that captured it.
"""

from __future__ import annotations

import collections
import time
from typing import Any

from spark_bagging_tpu_torch import telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock

#: demand classes, hottest first; exported numerically on the
#: ``sbt_capacity_demand_class`` gauge (2=hot, 1=warm, 0=cold)
CLASSES = ("hot", "warm", "cold")
CLASS_LEVEL = {"hot": 2.0, "warm": 1.0, "cold": 0.0}

#: rollup owner for cache entries whose fingerprint no registry commit
#: ever claimed (anonymous executors, failed swaps' pre-commit builds)
UNATTRIBUTED = "(unattributed)"


# -- measurement ladder ------------------------------------------------

def executable_bytes(program: Any) -> tuple[int | None, str]:
    """Device bytes held by one bucket program, with the source of
    truth: ``(n, "graph_pool")`` for a captured CUDA graph (its share of
    the executor's graph pool plus its static buffers, measured at the
    capture), ``(0, "eager")`` for a batch predict's eager program (it
    captures nothing), ``(None, "unmeasured")`` for anything that
    reports none — the CPU's serving program. Honest None, never a
    made-up 0."""
    nbytes = getattr(program, "nbytes", None)
    if nbytes is None:
        return None, "unmeasured"
    return int(nbytes), getattr(program, "bytes_source", "graph_pool")


def params_nbytes(executor: Any) -> int:
    """Bytes held by the executor's parameter tree and subspace index
    tensors — exact ``nbytes`` sums."""
    from spark_bagging_tpu_torch.serving.program_cache import tree_nbytes

    return tree_nbytes((getattr(executor, "_params", None),
                        getattr(executor, "_subspaces", None)))


def params_placement(executor: Any) -> str:
    """Where the parameters live: the first tensor's device type
    (``"cpu"``/``"cuda"``), or ``"host"`` for plain ndarrays."""
    import torch

    from spark_bagging_tpu_torch.serving.program_cache import _leaves

    for _path, leaf in _leaves((getattr(executor, "_params", None),
                                getattr(executor, "_subspaces", None))):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.type
        if leaf is not None:
            return "host"
    return "host"


# -- demand classification ---------------------------------------------

def classify_rate(
    prev: str | None,
    rate_rps: float,
    *,
    hot_rps: float,
    warm_rps: float,
    hysteresis: float = 0.5,
) -> str:
    """Hot/warm/cold with hysteresis: a model classified hot (warm)
    stays there until its rate falls below ``hysteresis`` × the
    threshold that admitted it — so a model oscillating around a
    boundary does not flap the class gauge (and any policy reading it)
    every window. Pure: (previous class, rate) → class."""
    if rate_rps >= hot_rps:
        return "hot"
    if prev == "hot" and rate_rps >= hot_rps * hysteresis:
        return "hot"
    if rate_rps >= warm_rps:
        return "warm"
    if prev in ("hot", "warm") and rate_rps >= warm_rps * hysteresis:
        return "warm"
    return "cold"


# -- the plane ---------------------------------------------------------

# sbt-lint: shared-state
class CapacityPlane:
    """Per-(model, version) residency ledger + fixed-memory demand
    accumulators + owner-attributed eviction ring.

    Fed from three seams: registry commits (``register_owner`` — the
    ONLY place fingerprints acquire owners), the executor's packed
    forward (``observe_demand``, behind the one-attribute-read probe),
    and program-cache evictions (``observe_eviction``). All reads that
    join against the program cache (``ledger``/``report``) snapshot
    the cache FIRST, then take the plane lock — the two locks are
    never held together, in either order.
    """

    def __init__(
        self,
        *,
        max_models: int = 256,
        hot_rps: float = 50.0,
        warm_rps: float = 1.0,
        hysteresis: float = 0.5,
        max_eviction_events: int = 128,
    ) -> None:
        self.max_models = int(max_models)
        self.hot_rps = float(hot_rps)
        self.warm_rps = float(warm_rps)
        self.hysteresis = float(hysteresis)
        self._lock = make_lock("telemetry.capacity")
        #: fingerprint -> {"model", "version", "live"} — written only
        #: at registry commit; the lazy-attribution join key
        self._owners: dict[str, dict[str, Any]] = {}
        #: (model, version) -> residency facts known at commit time
        self._ledger: dict[tuple[str, int], dict[str, Any]] = {}
        #: model -> demand accumulators (fixed memory: max_models cap)
        self._demand: dict[str, dict[str, Any]] = {}
        self._demand_dropped = 0
        #: owner label -> cumulative evictions charged to it
        self._evicted_by: dict[str, int] = {}
        self._eviction_events: collections.deque = collections.deque(
            maxlen=int(max_eviction_events)
        )

    # -- ownership (registry commit seam) ------------------------------

    def register_owner(
        self,
        executor: Any,
        *,
        retired_fingerprint: str | None = None,
    ) -> None:
        """Record a COMMITTED (model, version): called by the registry
        after ``register``/``swap`` succeed, never from their failure
        paths — which is the whole no-leak contract: a replacement that
        never went live never acquires an owner mapping, so its cache
        entries roll up as unattributed instead of leaking ledger rows.

        ``retired_fingerprint``: on swap, the outgoing executor's
        fingerprint — its mapping stays (old entries remain attributed
        for eviction accounting) but is marked not-live.

        A fingerprint a LIVE owner of another name already holds keeps
        that owner: a second executor of the same weights (a checkpoint
        loaded under a second name) adopts the first one's programs,
        whose bytes stay in the first one's graph pool.
        """
        model = executor.model_name
        version = int(executor.model_version)
        fingerprint = executor.fingerprint
        pbytes = params_nbytes(executor)
        placement = params_placement(executor)
        with self._lock:
            if retired_fingerprint and retired_fingerprint != fingerprint:
                prev = self._owners.get(retired_fingerprint)
                if prev is not None and prev["model"] == model:
                    prev["live"] = False
                    key = (prev["model"], prev["version"])
                    if key in self._ledger:
                        self._ledger[key]["live"] = False
            cur = self._owners.get(fingerprint)
            if cur is None or not cur["live"] or cur["model"] == model:
                self._owners[fingerprint] = {
                    "model": model, "version": version, "live": True,
                }
            self._ledger[(model, version)] = {
                "fingerprint": fingerprint,
                "params_bytes": pbytes,
                "placement": placement,
                # the JAX package's persisted-executable bytes: a CUDA
                # graph cannot be persisted, so none here
                "aot_disk_bytes": None,
                "live": True,
            }
            n_models = len({m for m, _ in self._ledger})
        telemetry.set_gauge(
            "sbt_capacity_params_bytes", float(pbytes),
            labels={"model": model, "version": str(version)},
        )
        telemetry.set_gauge("sbt_capacity_models", float(n_models))

    def owner_label(self, fingerprint: str) -> str | None:
        """The committed model name for ``fingerprint``, or None —
        the lazy-attribution lookup the program cache labels with."""
        with self._lock:
            rec = self._owners.get(fingerprint)
            return None if rec is None else rec["model"]

    def owner_of(self, fingerprint: str) -> dict[str, Any] | None:
        with self._lock:
            rec = self._owners.get(fingerprint)
            return None if rec is None else dict(rec)

    # -- demand (hot-path seam) ----------------------------------------

    def observe_demand(self, model: str, version: int | None,
                       requests: int, rows: int) -> None:
        """Accumulate one packed batch's demand against ``model``.
        Fixed memory: at most ``max_models`` tracked models; overflow
        is counted (``sbt_capacity_demand_dropped_total``), not grown.
        Called from ``_forward_packed`` under BOTH dispatch paths (the
        coalescing worker and the direct-dispatch inline serve), only
        when the plane is armed."""
        with self._lock:
            d = self._demand.get(model)
            if d is None:
                if len(self._demand) >= self.max_models:
                    self._demand_dropped += 1
                    d = None
                else:
                    d = {
                        "requests": 0, "rows": 0, "version": version,
                        "last_requests": 0, "last_now": None,
                        "rate_rps": 0.0, "class": "cold",
                    }
                    self._demand[model] = d
            if d is not None:
                d["requests"] += int(requests)
                d["rows"] += int(rows)
                d["version"] = version
        if d is None:
            telemetry.inc("sbt_capacity_demand_dropped_total")
            return
        labels = {"model": model}
        telemetry.inc("sbt_capacity_demand_requests_total",
                      float(requests), labels=labels)
        telemetry.inc("sbt_capacity_demand_rows_total",
                      float(rows), labels=labels)

    def classify(self, now: float | None = None) -> dict[str, dict]:
        """Advance one classification window: per-model interval rate
        since the last call, hysteresis class step, popularity rank
        (by cumulative requests, name tie-break). ``now`` is an
        injectable clock — wall by default, the virtual workload clock
        of a replayed workload (which makes classes a pure function of
        the workload). Returns {model: {requests, rows, rate_rps, class,
        rank}} and exports the demand gauges."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            for d in self._demand.values():
                last = d["last_now"]
                if last is None:
                    # first window: no interval yet — rate stays 0
                    d["last_now"] = now
                    d["last_requests"] = d["requests"]
                    continue
                dt = now - last
                if dt <= 0:
                    continue
                rate = (d["requests"] - d["last_requests"]) / dt
                d["rate_rps"] = rate
                d["class"] = classify_rate(
                    d["class"], rate, hot_rps=self.hot_rps,
                    warm_rps=self.warm_rps, hysteresis=self.hysteresis,
                )
                d["last_now"] = now
                d["last_requests"] = d["requests"]
            out = self._demand_view_locked()
        for model, d in out.items():
            labels = {"model": model}
            telemetry.set_gauge("sbt_capacity_demand_rate_rps",
                                d["rate_rps"], labels=labels)
            telemetry.set_gauge("sbt_capacity_demand_rank",
                                float(d["rank"]), labels=labels)
            telemetry.set_gauge("sbt_capacity_demand_class",
                                CLASS_LEVEL[d["class"]], labels=labels)
        return out

    def _demand_view_locked(self) -> dict[str, dict]:
        """Ranked copy of the demand table; caller holds the lock."""
        order = sorted(self._demand,
                       key=lambda m: (-self._demand[m]["requests"], m))
        out = {}
        for rank, model in enumerate(order, start=1):
            d = self._demand[model]
            out[model] = {
                "requests": d["requests"], "rows": d["rows"],
                "rate_rps": d["rate_rps"], "class": d["class"],
                "rank": rank,
            }
        return out

    def demand_summary(self) -> dict[str, dict]:
        """Deterministic demand view (cumulative counts + rank +
        class, no clocks) — a replay transcript's demand section."""
        with self._lock:
            view = self._demand_view_locked()
        return {
            m: {"requests": d["requests"], "rows": d["rows"],
                "rank": d["rank"], "class": d["class"]}
            for m, d in view.items()
        }

    def demand_class(self, model: str) -> str:
        with self._lock:
            d = self._demand.get(model)
            return "cold" if d is None else d["class"]

    # -- eviction attribution (program-cache seam) ---------------------

    def observe_eviction(self, *, fingerprint: str, bucket: int,
                         variant: str, nbytes: int | None,
                         seq: int) -> str:
        """Charge one program-cache eviction to its owner (or the
        unattributed rollup). Returns the owner label so the cache can
        emit the model-labeled eviction counter without a second
        lookup. ``seq`` is the cache's monotonic insert sequence — the
        workload-pure event clock a replay transcript records."""
        with self._lock:
            rec = self._owners.get(fingerprint)
            label = UNATTRIBUTED if rec is None else rec["model"]
            self._evicted_by[label] = self._evicted_by.get(label, 0) + 1
            self._eviction_events.append({
                "owner": label, "bucket": int(bucket),
                "variant": variant, "bytes": nbytes, "seq": int(seq),
            })
        return label

    def eviction_counts(self) -> dict[str, int]:
        """Cumulative evictions charged per owner, name-sorted —
        deterministic, so a replay transcript can carry it."""
        with self._lock:
            return {k: self._evicted_by[k]
                    for k in sorted(self._evicted_by)}

    def recent_evictions(self, limit: int = 32) -> list[dict]:
        with self._lock:
            events = list(self._eviction_events)
        return [dict(e) for e in events[-int(limit):]]

    # -- ledger + explainer (joins against the program cache) ----------

    def ledger(self) -> dict[str, Any]:
        """The reconciliation surface: the installed program cache's
        resident entries grouped by owner, joined with commit-time
        residency facts. ``reconciled`` asserts the grouping sums back
        to the cache's own totals — entries, measured bytes, and
        unmeasured counts all conserved."""
        from spark_bagging_tpu_torch.serving import program_cache as _pc

        snap = _pc.cache().snapshot()
        owners: dict[str, dict[str, Any]] = {}
        for e in snap["entries"]:
            label = self.owner_label(e["fingerprint"]) or UNATTRIBUTED
            o = owners.setdefault(label, {
                "entries": 0, "bytes": 0, "unmeasured": 0,
            })
            o["entries"] += 1
            if e["bytes"] is None:
                o["unmeasured"] += 1
            else:
                o["bytes"] += e["bytes"]
        with self._lock:
            committed = {
                f"{m}@{v}": {
                    "params_bytes": rec["params_bytes"],
                    "placement": rec["placement"],
                    "aot_disk_bytes": rec["aot_disk_bytes"],
                    "live": rec["live"],
                    "fingerprint": rec["fingerprint"],
                }
                for (m, v), rec in self._ledger.items()
            }
        reconciled = (
            sum(o["entries"] for o in owners.values()) == snap["entries_total"]
            and sum(o["bytes"] for o in owners.values()) == snap["bytes_total"]
            and sum(o["unmeasured"] for o in owners.values())
            == snap["unmeasured_total"]
        )
        for label, o in owners.items():
            if label != UNATTRIBUTED:
                telemetry.set_gauge("sbt_capacity_compiled_bytes",
                                    float(o["bytes"]),
                                    labels={"model": label})
                telemetry.set_gauge("sbt_capacity_resident_entries",
                                    float(o["entries"]),
                                    labels={"model": label})
                telemetry.set_gauge("sbt_capacity_unmeasured_entries",
                                    float(o["unmeasured"]),
                                    labels={"model": label})
        return {
            "cache": {
                "entries": snap["entries_total"],
                "capacity": snap["capacity"],
                "bytes": snap["bytes_total"],
                "unmeasured": snap["unmeasured_total"],
            },
            "owners": {k: owners[k] for k in sorted(owners)},
            "committed": committed,
            "reconciled": reconciled,
        }

    def export_gauges(self) -> None:
        """Refresh the policy-input gauges the alert rules read:
        cache headroom ratio and cold-but-resident entry count. Called
        on scrape (``telemetry/server.py``) and from ``report``."""
        led = self.ledger()
        cache = led["cache"]
        cap = cache["capacity"] or 1
        headroom = max(0.0, (cap - cache["entries"]) / cap)
        cold = 0
        for label, o in led["owners"].items():
            if label == UNATTRIBUTED:
                continue
            if self.demand_class(label) == "cold":
                cold += o["entries"]
        telemetry.set_gauge("sbt_capacity_cache_headroom_ratio", headroom)
        telemetry.set_gauge("sbt_capacity_cold_resident_entries",
                            float(cold))

    def report(self, *, limit: int = 64) -> dict[str, Any]:
        """The ``/debug/capacity`` body: ledger + per-resident
        eviction-decision explainer (LRU-first — position 0 is next to
        evict) + demand table + recent evictions + device memory.
        Every explainer row carries the exact inputs a residency
        policy would weigh: LRU position, demand rank/class, bytes
        reclaimable (None when unmeasured), last-hit age."""
        from spark_bagging_tpu_torch.serving import program_cache as _pc
        from spark_bagging_tpu_torch.utils.memory import device_memory_stats

        snap = _pc.cache().snapshot()
        led = self.ledger()
        demand = self.demand_summary()
        now = time.time()
        residents = []
        for e in snap["entries"][:int(limit)]:
            owner = self.owner_of(e["fingerprint"])
            label = UNATTRIBUTED if owner is None else owner["model"]
            d = demand.get(label)
            last_hit = e["ts_last_hit"]
            residents.append({
                "owner": label,
                "version": None if owner is None else owner["version"],
                "live": None if owner is None else owner["live"],
                "bucket": e["bucket"],
                "variant": e["variant"],
                "lru_position": e["lru_position"],
                "bytes_reclaimable": e["bytes"],
                "bytes_source": e["source"],
                "unmeasured": e["bytes"] is None,
                "hits": e["hits"],
                "last_hit_age_s": (None if last_hit is None
                                   else max(0.0, now - last_hit)),
                "demand_rank": None if d is None else d["rank"],
                "demand_class": "cold" if d is None else d["class"],
            })
        self.export_gauges()
        with self._lock:
            dropped = self._demand_dropped
        return {
            "enabled": True,
            "thresholds": {
                "hot_rps": self.hot_rps, "warm_rps": self.warm_rps,
                "hysteresis": self.hysteresis,
            },
            "cache": led["cache"],
            "owners": led["owners"],
            "committed": led["committed"],
            "reconciled": led["reconciled"],
            "residents": residents,
            "demand": demand,
            "demand_dropped": dropped,
            "evictions_by_owner": self.eviction_counts(),
            "evictions_recent": self.recent_evictions(),
            "device_memory": device_memory_stats(),
        }


def capacity_report(*, limit: int = 64) -> dict[str, Any]:
    """Route-friendly report: the armed plane's full explainer, or an
    honest disabled stub that still shows the cache totals."""
    plane = ACTIVE
    if plane is None:
        from spark_bagging_tpu_torch.serving import program_cache as _pc

        return {
            "enabled": False,
            "cache": _pc.cache().stats(),
            "note": ("capacity plane not armed — "
                     "telemetry.capacity.enable() to attribute"),
        }
    return plane.report(limit=limit)


# -- process default ---------------------------------------------------

#: the probe target: serving hot paths read this ONE module attribute
#: (the ``faults.ACTIVE`` pattern) — None means the plane is off and
#: the probe cost is a single attribute read
ACTIVE: "CapacityPlane | None" = None

_default_lock = make_lock("telemetry.capacity.default")


def enable(**kwargs: Any) -> CapacityPlane:
    """Install a fresh :class:`CapacityPlane` as the process plane
    (``kwargs`` are its constructor options). A second enable starts a
    new accounting window — the old plane's state stays readable but
    is no longer fed."""
    global ACTIVE
    plane = CapacityPlane(**kwargs)
    with _default_lock:
        ACTIVE = plane
    return plane


def disable() -> None:
    """Uninstall the process plane (probes go back to one attribute
    read; accumulated state on the old plane stays readable)."""
    global ACTIVE
    with _default_lock:
        ACTIVE = None


def install(plane: "CapacityPlane | None") -> "CapacityPlane | None":
    """Install ``plane`` (or None) as the probe target, returning the
    previous one — the save/restore seam of tests and harnesses."""
    global ACTIVE
    with _default_lock:
        prev = ACTIVE
        ACTIVE = plane
    return prev


def get() -> "CapacityPlane | None":
    """The installed plane, or None."""
    return ACTIVE
