"""Performance attribution plane — where the time and compute go.

The observability stack already says *that* serving is slow (latency
histograms, SLO gates, burn rates); this module says *where*: which
pipeline stage the milliseconds went to, what each bucket's forward
actually costs in measured seconds against its counted FLOPs, and —
for a specific slow request — *why* (the tail explainer). Three
layers, all fed from seams that already exist:

1. **Per-stage cost accounting.** Every request trace's breakdown
   (``queue_ms``/``batch_ms``/``forward_ms``, path, bucket,
   model_version — built by the batcher) rolls up into
   fixed-memory per-stage accumulators: ``sbt_perf_stage_seconds``
   histograms and ``sbt_perf_stage_share`` gauges labeled
   ``{stage, path[, model]}``, where the stages decompose the request
   wall-clock exactly (``queue`` + ``forward`` + ``scatter`` ==
   ``total``; scatter is the batch window minus the device forward —
   claim, packing, result delivery).
2. **A measured cost model.** Each slab forward's wall-clock joins the
   executor's build-time ``bucket_costs`` (the forward's matrix-product
   FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode`` over
   one eager call at the bucket's shape; bytes as every input read once
   and the output written once) into a live per-bucket table:
   ``sbt_perf_bucket_seconds_per_row``, achieved FLOP/s
   (``sbt_perf_bucket_achieved_flops``), and serving MFU
   (``sbt_perf_mfu``: achieved FLOP/s over the card's dense bf16 peak,
   ``utils.profiling.device_peak_tflops()``; None on the CPU) — the
   measured seconds-per-row a cost-driven bucket ladder needs (static
   counts alone can't rank rungs a real host runs at different
   efficiencies).
3. **The tail explainer.** The plane retains a small deterministic
   top-K-by-duration reservoir of slow-request breakdowns;
   :func:`correlate_tail` joins each against concurrent process
   events (compiles, swaps, retries/bisects, crash-loop/degraded
   transitions, overload bursts — the flight recorder's ring) inside
   a time window and emits a deterministic per-request verdict:
   ``queue-dominated`` / ``compile-absorbed`` / ``retry-inflated`` /
   ``degraded-path`` / ``genuinely-slow-forward`` (plus ``failed``).
   Served live at ``/debug/tail``; deterministic on an injected
   clock.

The port's copy of the JAX package's ``telemetry/perf.py``. The
tenancy journey's stages and verdicts read the breakdowns of requests
the tenancy fleet (``tenancy/fleet.py``) minted; without a fleet no
breakdown carries a tenant and they never fire.

Cost contract: the plane is **opt-in** (:func:`enable`). The probes
compiled into the hot paths are the ``faults.ACTIVE`` pattern — one
module-attribute read when no plane is installed, no lock, no call —
and the breakdown probe rides the existing trace construction (no
trace, no probe). All accumulation is fixed-memory: label keys are
capped (overflow counted in ``sbt_perf_dropped_total``), the slow
reservoir is bounded, and registry exports happen every
``refresh_every`` observations, not per request.
"""

from __future__ import annotations

import time
from typing import Any, Iterable

from spark_bagging_tpu_torch.analysis.locks import make_lock

#: the request wall-clock decomposition (exact: they sum to total_ms)
STAGES = ("queue", "forward", "scatter")

#: the tenancy journey's pre-batcher stages: together with
#: :data:`STAGES` they tile a fleet request's wall-clock exactly
#: (admission + wfq + restore + dispatch + queue + forward + scatter
#: == total, re-based to the fleet submit instant)
JOURNEY_STAGES = ("admission", "wfq", "restore", "dispatch")

#: the tail explainer's verdict grammar, in priority order — the first
#: rule whose evidence is present wins. The tenancy rungs
#: (quarantine-shed / restore-absorbed / wfq-starved) sit above
#: queue-dominated: a tail-tenant request that waited behind a
#: heavier tenant or absorbed a cold restore must not be misfiled as
#: generic queueing
VERDICTS = ("failed", "degraded-path", "retry-inflated",
            "compile-absorbed", "quarantine-shed", "restore-absorbed",
            "wfq-starved", "queue-dominated",
            "genuinely-slow-forward")

# event kinds (and span names) each verdict's evidence join matches
_DEGRADED_KINDS = frozenset((
    "serving_shard_failed", "serving_crash_loop",
    "serving_degraded_reject", "serving_degraded",
))
_RETRY_KINDS = frozenset((
    "serving_retry", "serving_bisect", "serving_batch_error",
))
_COMPILE_KINDS = frozenset(("serving_compile", "model_swapped",
                            "swap_failed"))
_COMPILE_SPAN_NAMES = frozenset(("serving_compile",
                                 "quality_replica_compile"))
_OVERLOAD_KINDS = frozenset(("serving_overloaded",))
# tenancy_shed events are reason-qualified at join time (kind:reason)
# so an overload shed never counts as quarantine evidence
_QUARANTINE_KINDS = frozenset(("tenant_quarantine_trip",
                               "tenancy_shed:quarantine"))
_RESTORE_KINDS = frozenset(("tenancy_restore",))


# sbt-lint: shared-state
class PerfAttribution:
    """Fixed-memory attribution accumulators for one serving process.

    ``slow_k`` bounds the top-K-by-duration breakdown reservoir the
    tail explainer reads; ``refresh_every`` is the registry-export
    cadence in observations (0 = never auto-export — a replay
    harness reads :meth:`summary` directly); ``max_keys`` caps the
    distinct ``(stage, path, model)`` label keys (overflow folds into
    ``sbt_perf_dropped_total`` rather than growing without bound).
    """

    def __init__(self, *, slow_k: int = 8, refresh_every: int = 64,
                 max_keys: int = 32) -> None:
        if slow_k < 1 or max_keys < 1:
            raise ValueError("slow_k and max_keys must be >= 1")
        if refresh_every < 0:
            raise ValueError(
                f"refresh_every must be >= 0, got {refresh_every}"
            )
        self.slow_k = int(slow_k)
        self.refresh_every = int(refresh_every)
        self.max_keys = int(max_keys)
        self._lock = make_lock("telemetry.perf")
        # (path, model) -> {"requests", "queue_s", "forward_s",
        #                   "scatter_s", "total_s"}
        self._keys: dict[tuple, dict[str, float]] = {}
        # tenant -> per-stage seconds over the FULL journey
        # (admission/wfq/restore/dispatch + queue/forward/scatter),
        # plus requests/sheds/total_s — same max_keys cap
        self._tenants: dict[str, dict[str, float]] = {}
        self._dropped = 0
        self._dropped_exported = 0
        # bucket -> {"forwards", "rows", "seconds", "flops", "bytes"}
        # (flops/bytes are PER-FORWARD build-time constants)
        self._buckets: dict[int, dict[str, float | None]] = {}
        self._slow: list[dict[str, Any]] = []
        self._n = 0
        self._peak_tflops: float | None = None
        self._peak_resolved = False

    # -- probes (called from the serving hot paths while installed) ----

    def observe_breakdown(self, bd: dict, *,
                          trace_id: str | None = None) -> None:
        """Fold one completed request breakdown into the stage
        rollups and the slow reservoir. Called by the batcher right
        after it finishes the breakdown — the record is exactly what
        ``future.trace.breakdown`` carries."""
        queue_s = (bd.get("queue_ms") or 0.0) / 1e3
        forward_s = (bd.get("forward_ms") or 0.0) / 1e3
        batch_s = (bd.get("batch_ms") or 0.0) / 1e3
        scatter_s = max(0.0, batch_s - forward_s)
        total_s = (bd.get("total_ms") or 0.0) / 1e3
        path = bd.get("path") or "coalesced"
        model = bd.get("model_name")
        tenant = bd.get("tenant")
        journey_s = {
            s: (bd.get(f"{s}_ms") or 0.0) / 1e3 for s in JOURNEY_STAGES
        } if tenant is not None else None
        key = (path, str(model) if model is not None else None)
        export = False
        accepted = True
        tenant_accepted = False
        with self._lock:
            acc = self._keys.get(key)
            if acc is None:
                if len(self._keys) >= self.max_keys:
                    self._dropped += 1
                    accepted = False
                else:
                    acc = self._keys[key] = {
                        "requests": 0.0, "queue_s": 0.0,
                        "forward_s": 0.0, "scatter_s": 0.0,
                        "total_s": 0.0,
                    }
            if acc is not None:
                acc["requests"] += 1
                acc["queue_s"] += queue_s
                acc["forward_s"] += forward_s
                acc["scatter_s"] += scatter_s
                acc["total_s"] += total_s
            if tenant is not None:
                tacc = self._tenants.get(tenant)
                if tacc is None:
                    if len(self._tenants) >= self.max_keys:
                        self._dropped += 1
                    else:
                        tacc = self._tenants[tenant] = {
                            "requests": 0.0, "sheds": 0.0,
                            "total_s": 0.0,
                            **{f"{s}_s": 0.0
                               for s in JOURNEY_STAGES + STAGES},
                        }
                if tacc is not None:
                    tenant_accepted = True
                    tacc["requests"] += 1
                    if bd.get("shed") is not None:
                        tacc["sheds"] += 1
                    tacc["total_s"] += total_s
                    for s, v in journey_s.items():
                        tacc[f"{s}_s"] += v
                    tacc["queue_s"] += queue_s
                    tacc["forward_s"] += forward_s
                    tacc["scatter_s"] += scatter_s
            # deterministic top-K by duration: strictly-greater evicts
            # the current minimum, ties keep the incumbent
            record = {
                "trace_id": trace_id,
                "ts": time.time(),
                "total_ms": bd.get("total_ms"),
                "queue_ms": bd.get("queue_ms"),
                "forward_ms": bd.get("forward_ms"),
                "batch_ms": bd.get("batch_ms"),
                "path": path,
                "bucket": bd.get("bucket"),
                "batch_size": bd.get("batch_size"),
                "model_name": bd.get("model_name"),
                "model_version": bd.get("model_version"),
            }
            if tenant is not None:
                # the journey fields ride into the reservoir so the
                # tail explainer can verdict wfq-starved /
                # restore-absorbed / quarantine-shed and /debug/tail
                # can filter by tenant
                record["tenant"] = tenant
                for s in JOURNEY_STAGES:
                    record[f"{s}_ms"] = bd.get(f"{s}_ms")
                if bd.get("shed") is not None:
                    record["shed"] = bd["shed"]
            if bd.get("error") is not None:
                record["error"] = bd["error"]
            slow = self._slow
            if len(slow) < self.slow_k:
                slow.append(record)
            else:
                m = min(range(len(slow)),
                        key=lambda i: slow[i]["total_ms"] or 0.0)
                if total_s * 1e3 > (slow[m]["total_ms"] or 0.0):
                    slow[m] = record
            self._n += 1
            if self.refresh_every and self._n % self.refresh_every == 0:
                export = True
        if export:
            self.export()
        # the stage histograms export per observation (they are the
        # distribution; shares and the cost table batch on the
        # cadence) — gated by the SAME key cap as the accumulators:
        # registry series are keyed by label set, so exporting a
        # dropped key would grow the registry without bound and defeat
        # the fixed-memory contract the cap exists for
        from spark_bagging_tpu_torch import telemetry

        if accepted and telemetry.enabled():
            labels = {"path": path}
            if model is not None:
                labels["model"] = str(model)
            for stage, v in (("queue", queue_s),
                             ("forward", forward_s),
                             ("scatter", scatter_s)):
                telemetry.observe("sbt_perf_stage_seconds", v,
                                  labels={"stage": stage, **labels},
                                  exemplar=trace_id)
        if tenant_accepted and telemetry.enabled():
            # the tenant-labeled journey twins — same series, tenant
            # dimension, full stage set (capped by the SAME max_keys
            # gate as the accumulators)
            pairs = [(s, journey_s[s]) for s in JOURNEY_STAGES]
            pairs += [("queue", queue_s), ("forward", forward_s),
                      ("scatter", scatter_s)]
            for stage, v in pairs:
                telemetry.observe(
                    "sbt_perf_stage_seconds", v,
                    labels={"stage": stage, "tenant": tenant},
                    exemplar=trace_id)

    def observe_forward(self, bucket: int, fill: int, seconds: float,
                        cost: dict | None = None) -> None:
        """Fold one slab forward's measured wall-clock into the
        per-bucket cost model. ``cost`` is the executor's
        ``bucket_costs[bucket]`` entry (FLOPs/bytes per forward counted
        at the bucket's build — ``flops`` None when the forward runs no
        counted product)."""
        with self._lock:
            acc = self._buckets.get(bucket)
            if acc is None:
                if len(self._buckets) >= self.max_keys:
                    self._dropped += 1
                    return
                acc = self._buckets[bucket] = {
                    "forwards": 0.0, "rows": 0.0, "seconds": 0.0,
                    "flops": None, "bytes": None,
                }
            acc["forwards"] += 1
            acc["rows"] += fill
            acc["seconds"] += seconds
            if cost:
                if cost.get("flops") is not None:
                    acc["flops"] = float(cost["flops"])
                if cost.get("bytes") is not None:
                    acc["bytes"] = float(cost["bytes"])

    # -- views ---------------------------------------------------------

    def _peak(self) -> float | None:
        """Device peak TFLOP/s, resolved once (it queries torch.cuda)."""
        if not self._peak_resolved:
            from spark_bagging_tpu_torch.utils.profiling import (
                device_peak_tflops,
            )

            # sbt-lint: disable=shared-state-unlocked — idempotent lazy resolve; racing writers compute the same value
            self._peak_tflops = device_peak_tflops()
            # sbt-lint: disable=shared-state-unlocked — same benign idempotent write
            self._peak_resolved = True
        return self._peak_tflops

    def cost_model(self) -> dict[str, dict[str, float | None]]:
        """The live per-bucket cost table: measured seconds-per-row,
        achieved FLOP/s, and MFU against the device bf16 peak (None
        when the device kind is unknown — CPU — or the backend
        reported no FLOPs)."""
        peak = self._peak()
        with self._lock:
            buckets = {b: dict(acc) for b, acc in self._buckets.items()}
        out: dict[str, dict[str, float | None]] = {}
        for b in sorted(buckets):
            acc = buckets[b]
            seconds, rows = acc["seconds"], acc["rows"]
            flops = acc["flops"]
            achieved = (flops * acc["forwards"] / seconds
                        if flops and seconds > 0 else None)
            out[str(b)] = {
                "forwards": int(acc["forwards"]),
                "rows": int(rows),
                "seconds": round(seconds, 6),
                "flops_per_forward": flops,
                "bytes_per_forward": acc["bytes"],
                "seconds_per_row": (seconds / rows if rows else None),
                "achieved_flops": achieved,
                "mfu": (achieved / (peak * 1e12)
                        if achieved is not None and peak else None),
            }
        return out

    def summary(self) -> dict[str, Any]:
        """One JSON-friendly view of the whole plane: overall and
        per-(path, model) stage totals + shares, the cost-model table,
        MFU, and the slow reservoir."""
        with self._lock:
            keys = {k: dict(v) for k, v in self._keys.items()}
            tenants = {t: dict(v) for t, v in self._tenants.items()}
            n = self._n
            dropped = self._dropped
        stages_total = {s: 0.0 for s in STAGES}
        total_s = 0.0
        by_key = []
        for (path, model), acc in sorted(keys.items(),
                                         key=lambda kv: str(kv[0])):
            for s in STAGES:
                stages_total[s] += acc[f"{s}_s"]
            total_s += acc["total_s"]
            entry = {
                "path": path, "model": model,
                "requests": int(acc["requests"]),
                "stages": _shares(acc),
            }
            by_key.append(entry)
        cost = self.cost_model()
        peak = self._peak()
        # overall achieved FLOP/s: total flops dispatched over total
        # measured forward seconds (the time-weighted mean, not a mean
        # of per-bucket rates)
        flops_total = sum(
            (c["flops_per_forward"] or 0.0) * c["forwards"]
            for c in cost.values()
        )
        sec_total = sum(c["seconds"] for c in cost.values())
        overall = (flops_total / sec_total
                   if sec_total > 0 and flops_total > 0 else None)
        return {
            "requests": int(n),
            "dropped_keys": int(dropped),
            "stages": {
                s: {
                    "seconds": round(stages_total[s], 6),
                    "share": (stages_total[s] / total_s
                              if total_s > 0 else None),
                }
                for s in STAGES
            },
            "by_key": by_key,
            "tenants": {
                t: {
                    "requests": int(acc["requests"]),
                    "sheds": int(acc["sheds"]),
                    "stages": _journey_shares(acc),
                }
                for t, acc in sorted(tenants.items())
            },
            "cost_model": cost,
            "achieved_flops": overall,
            "peak_tflops_bf16": peak,
            "mfu": (overall / (peak * 1e12)
                    if overall is not None and peak else None),
            "slow": self.slow_records(),
        }

    def slow_records(self, limit: int | None = None) -> list[dict]:
        """The retained slowest breakdowns, slowest first."""
        with self._lock:
            out = sorted(self._slow,
                         key=lambda r: -(r["total_ms"] or 0.0))
        return [dict(r) for r in (out[:limit] if limit else out)]

    def export(self) -> None:
        """Push the share gauges and cost-model gauges to the metrics
        registry (called on the ``refresh_every`` cadence and by the
        ``/debug/tail`` scrape)."""
        from spark_bagging_tpu_torch import telemetry

        if not telemetry.enabled():
            return
        with self._lock:
            keys = {k: dict(v) for k, v in self._keys.items()}
            tenants = {t: dict(v) for t, v in self._tenants.items()}
            dropped_delta = self._dropped - self._dropped_exported
            self._dropped_exported = self._dropped
        for (path, model), acc in keys.items():
            labels = {"path": path}
            if model is not None:
                labels["model"] = model
            for stage, share in _shares(acc).items():
                if share["share"] is not None:
                    telemetry.set_gauge(
                        "sbt_perf_stage_share", share["share"],
                        labels={"stage": stage, **labels},
                    )
        for tenant, acc in tenants.items():
            for stage, share in _journey_shares(acc).items():
                if share["share"] is not None:
                    telemetry.set_gauge(
                        "sbt_perf_stage_share", share["share"],
                        labels={"stage": stage, "tenant": tenant},
                    )
        if dropped_delta > 0:
            telemetry.inc("sbt_perf_dropped_total", dropped_delta)
        cost = self.cost_model()
        for b, c in cost.items():
            labels = {"bucket": b}
            if c["seconds_per_row"] is not None:
                telemetry.set_gauge("sbt_perf_bucket_seconds_per_row",
                                    c["seconds_per_row"], labels=labels)
            if c["achieved_flops"] is not None:
                telemetry.set_gauge("sbt_perf_bucket_achieved_flops",
                                    c["achieved_flops"], labels=labels)
        peak = self._peak()
        flops_total = sum(
            (c["flops_per_forward"] or 0.0) * c["forwards"]
            for c in cost.values()
        )
        sec_total = sum(c["seconds"] for c in cost.values())
        if peak and sec_total > 0 and flops_total > 0:
            telemetry.set_gauge(
                "sbt_perf_mfu", flops_total / sec_total / (peak * 1e12)
            )


def _shares(acc: dict[str, float]) -> dict[str, dict]:
    total = acc["total_s"]
    return {
        s: {
            "seconds": round(acc[f"{s}_s"], 6),
            "share": (acc[f"{s}_s"] / total if total > 0 else None),
        }
        for s in STAGES
    }


def _journey_shares(acc: dict[str, float]) -> dict[str, dict]:
    """Per-stage seconds + shares over the FULL tenancy journey
    (pre-batcher stages included) — the tenant twin of
    :func:`_shares`."""
    total = acc["total_s"]
    return {
        s: {
            "seconds": round(acc[f"{s}_s"], 6),
            "share": (acc[f"{s}_s"] / total if total > 0 else None),
        }
        for s in JOURNEY_STAGES + STAGES
    }


# -- the tail explainer ------------------------------------------------

def correlate_tail(
    records: Iterable[dict],
    events: Iterable[dict],
    *,
    window_s: float = 1.0,
    queue_frac: float = 0.5,
    queue_threshold_ms: float | None = None,
    clock_key: str = "ts",
) -> list[dict]:
    """Explain each slow-request record by joining it against the
    concurrent process events, emitting a deterministic verdict.

    ``records`` carry at least a timestamp under ``clock_key`` plus
    (when known) the breakdown fields (``total_ms``/``queue_ms``/
    ``error``...). ``events`` are process events — the flight
    recorder's ring in production, counter-delta-synthesized virtual
    events in replay — matched when their ``clock_key`` (falling back
    to ``ts``) lies within ``window_s`` of the record's.

    The verdict is the FIRST rule in priority order whose evidence is
    present (every matched factor is still listed):

    1. ``failed`` — the record carries an error;
    2. ``degraded-path`` — shard loss / crash loop / degraded
       transitions in the window (or the record says ``degraded``);
    3. ``retry-inflated`` — retries, bisects, or batch errors in the
       window;
    4. ``compile-absorbed`` — a serving compile (or a swap, whose warm
       pre-compiles are the usual carrier) in the window;
    5. ``quarantine-shed`` — the record IS a quarantine shed (its
       ``shed`` field says so) or a quarantine trip / quarantine shed
       event lands in the window;
    6. ``restore-absorbed`` — the record carries ``restore_ms > 0``
       (it paid a cold tenant's AOT restore) or a ``tenancy_restore``
       event for its window;
    7. ``wfq-starved`` — fair-queue wait over ``queue_frac`` of the
       total (or over ``queue_threshold_ms`` when the total is
       unknown): the request waited behind heavier tenants, not
       behind its own batcher;
    8. ``queue-dominated`` — queue wait over ``queue_frac`` of the
       total (or over ``queue_threshold_ms`` when the total is
       unknown — a replay harness passes the coalescing window's
       half, making the verdict a pure function of the schedule);
    9. ``genuinely-slow-forward`` — none of the above: the device
       forward itself was the time.
    """
    evs = []
    for e in events:
        t = e.get(clock_key)
        if t is None:
            t = e.get("ts")
        if t is None:
            continue
        kind = e.get("kind")
        if kind == "span":
            if e.get("name") not in _COMPILE_SPAN_NAMES:
                continue
            kind = "serving_compile"
        elif kind == "tenancy_shed":
            # reason-qualified so only quarantine sheds count as
            # quarantine evidence (an overload shed is queue weather)
            kind = f"tenancy_shed:{e.get('reason')}"
        evs.append((float(t), kind))
    evs.sort()
    out = []
    for r in records:
        t = r.get(clock_key)
        if t is None:
            t = r.get("ts")
        nearby: list[tuple[float, str]] = []
        if t is not None:
            lo, hi = float(t) - window_s, float(t) + window_s
            nearby = [(et, k) for et, k in evs if lo <= et <= hi]
        factors = []
        kinds = {k for _, k in nearby}
        if r.get("error") is not None:
            factors.append("error")
        if kinds & _DEGRADED_KINDS or r.get("degraded"):
            factors.append("degraded")
        if kinds & _RETRY_KINDS:
            factors.append("retries")
        if kinds & _COMPILE_KINDS:
            factors.append("compiles")
        if kinds & _OVERLOAD_KINDS:
            factors.append("overload-burst")
        if (r.get("shed") == "quarantine"
                or kinds & _QUARANTINE_KINDS):
            factors.append("quarantine")
        if ((r.get("restore_ms") or 0.0) > 0
                or kinds & _RESTORE_KINDS):
            factors.append("restore")
        queue_ms = r.get("queue_ms")
        total_ms = r.get("total_ms")
        wfq_ms = r.get("wfq_ms")
        queue_heavy = False
        if queue_ms is not None:
            if total_ms:
                queue_heavy = queue_ms / total_ms >= queue_frac
            elif queue_threshold_ms is not None:
                queue_heavy = queue_ms >= queue_threshold_ms
        wfq_heavy = False
        if wfq_ms is not None:
            if total_ms:
                wfq_heavy = wfq_ms / total_ms >= queue_frac
            elif queue_threshold_ms is not None:
                wfq_heavy = wfq_ms >= queue_threshold_ms
        if wfq_heavy:
            factors.append("wfq")
        if queue_heavy or "overload-burst" in factors:
            factors.append("queue")
        if "error" in factors:
            verdict = "failed"
        elif "degraded" in factors:
            verdict = "degraded-path"
        elif "retries" in factors:
            verdict = "retry-inflated"
        elif "compiles" in factors:
            verdict = "compile-absorbed"
        elif "quarantine" in factors:
            verdict = "quarantine-shed"
        elif "restore" in factors:
            verdict = "restore-absorbed"
        elif "wfq" in factors:
            verdict = "wfq-starved"
        elif "queue" in factors:
            verdict = "queue-dominated"
        else:
            verdict = "genuinely-slow-forward"
        entry = {
            "verdict": verdict,
            "factors": factors,
            "events_in_window": len(nearby),
            "evidence": [
                {"t": et, "kind": k} for et, k in nearby[:8]
            ],
        }
        for k in ("trace_id", "idx", "total_ms", "queue_ms",
                  "forward_ms", "path", "bucket", "batch_size",
                  "error", "tenant", "admission_ms", "wfq_ms",
                  "restore_ms", "dispatch_ms", "shed"):
            if r.get(k) is not None:
                entry[k] = r[k]
        if t is not None:
            entry["t"] = float(t)
        out.append(entry)
    return out


def tail_report(*, limit: int = 8, window_s: float = 1.0,
                tenant: str | None = None) -> dict:
    """The ``/debug/tail`` body: the slowest retained requests (the
    perf plane's reservoir when installed, else the latency
    histogram's exemplars + top-K reservoir) each explained against
    the flight recorder's event ring. ``tenant`` filters to one
    tenant's records (``/debug/tail?tenant=``) — fleet records carry
    the tenant on the breakdown, so the tail forensics answer "why is
    THIS tenant slow" directly."""
    from spark_bagging_tpu_torch import telemetry
    from spark_bagging_tpu_torch.telemetry import recorder

    plane = ACTIVE
    source = "perf-reservoir"
    records = plane.slow_records() if plane is not None else []
    if not records:
        source = "latency-exemplars"
        records = _exemplar_records(limit)
    if tenant is not None:
        records = [r for r in records if r.get("tenant") == tenant]
    records = records[:limit]
    rec = recorder.get()
    events = rec.events() if rec is not None else []
    tail = correlate_tail(records, events, window_s=window_s)
    tail.sort(key=lambda r: -(r.get("total_ms") or 0.0))
    out = {
        "source": source,
        "window_s": window_s,
        "tenant": tenant,
        "perf_plane_active": plane is not None,
        "flight_recorder_armed": rec is not None and rec.armed,
        "tail": tail,
    }
    if plane is not None:
        plane.export()
        summary = plane.summary()
        out["stages"] = summary["stages"]
        if tenant is not None:
            out["tenant_stages"] = summary["tenants"].get(tenant)
    if not tail:
        out["note"] = (
            "no slow-request records retained yet; enable the perf "
            "plane (telemetry.perf.enable()) and serve traffic, or "
            "wait for latency exemplars"
        )
    return out


def _exemplar_records(limit: int) -> list[dict]:
    """Fallback tail records off the request-latency histogram's
    exemplars (newest per bucket) and top-K-by-duration reservoir —
    trace id + latency only (no breakdown), which still supports the
    event-join verdicts."""
    from spark_bagging_tpu_torch import telemetry

    h = telemetry.registry().peek("sbt_serving_latency_seconds")
    if h is None or h.kind != "histogram":
        return []
    seen: dict[str, dict] = {}
    pool = list(h.exemplars.values()) + list(h.slow_exemplars)
    for ex in pool:
        tid = ex.get("trace_id")
        if tid is None:
            continue
        cur = seen.get(tid)
        if cur is None or (ex.get("value") or 0) > (cur.get("value") or 0):
            seen[tid] = ex
    records = [
        {
            "trace_id": tid,
            "ts": ex.get("ts"),
            "total_ms": ((ex.get("value") or 0.0) * 1e3) or None,
        }
        for tid, ex in seen.items()
    ]
    records.sort(key=lambda r: -(r["total_ms"] or 0.0))
    return records[:limit]


# -- process default ---------------------------------------------------

#: the probe target: serving hot paths read this ONE module attribute
#: (the ``faults.ACTIVE`` pattern) — None means the plane is off and
#: the probe cost is a single attribute read
ACTIVE: "PerfAttribution | None" = None

_default_lock = make_lock("telemetry.perf.default")


def enable(**kwargs: Any) -> PerfAttribution:
    """Install a fresh :class:`PerfAttribution` as the process plane
    (``kwargs`` are its constructor options). A second enable starts a
    new measurement window — the old plane's accumulators are simply
    no longer fed."""
    global ACTIVE
    plane = PerfAttribution(**kwargs)
    with _default_lock:
        ACTIVE = plane
    return plane


def disable() -> None:
    """Uninstall the process plane (probes go back to one attribute
    read; accumulated state on the old plane stays readable)."""
    global ACTIVE
    with _default_lock:
        ACTIVE = None


def install(plane: "PerfAttribution | None") -> "PerfAttribution | None":
    """Install ``plane`` (or None) as the probe target, returning the
    previous one — the save/restore seam of tests and harnesses."""
    global ACTIVE
    with _default_lock:
        prev = ACTIVE
        ACTIVE = plane
    return prev


def get() -> "PerfAttribution | None":
    """The installed plane, or None."""
    return ACTIVE
