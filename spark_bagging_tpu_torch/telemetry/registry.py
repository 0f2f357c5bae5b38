"""Process-wide metrics registry: counters, gauges, log-scale histograms.

A copy of the JAX package's ``telemetry/registry.py``: one thread-safe
registry holds every counter/gauge/histogram the port emits (the
serving plane's ``sbt_serving_*`` series, the program cache's, the
checkpoint's, the fault injector's, the quality plane's, the alert
engine's, the flight recorder's, the online trainer's, the fit
report's, and the capacity, performance, fleet, history and process
planes'), keyed by ``(name, sorted labels)``. Metric names follow
the Prometheus convention with the ``sbt_`` (spark-bagging-tpu) prefix;
:func:`render_prometheus` emits the text exposition format so the
registry can be scraped or diffed with standard tooling.

Thread-safety: the serving plane emits from submitter threads, the
batcher worker and swap callers concurrently — every mutation and
snapshot takes the registry lock. The hot-path
cheapness contract lives one level up (``telemetry.enabled()`` gates
every call site), not here.
"""

from __future__ import annotations

import math
import time
from typing import Any, Iterable

from spark_bagging_tpu_torch.analysis.locks import make_lock

# Log-scale histogram bounds: decades from 100 microseconds to 1000
# seconds cover every latency this stack records (a served request,
# a bucket's graph capture, a checkpoint write).
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    10.0 ** e for e in range(-4, 4)
) + (math.inf,)

# Help text for every sbt_* series the port emits — the single source
# `render_prometheus` emits `# HELP` lines from. Dynamic series (the
# per-fit-report `sbt_fit_<key>` gauges) are covered by prefix in
# `_help_for`. Keep entries one line: the exposition format forbids
# raw newlines in HELP text.
SERIES_HELP: dict[str, str] = {
    "sbt_checkpoint_bytes_total": "Checkpoint bytes written or read (labels kind, op)",
    "sbt_checkpoint_seconds": "Checkpoint save/load wall-clock (histogram)",
    "sbt_serving_requests_total": "Requests admitted by MicroBatcher.submit()",
    "sbt_serving_rows_total": "Rows served through the executor forward",
    "sbt_serving_batches_total": "Coalesced micro-batches forwarded",
    "sbt_serving_queue_depth": "Requests admitted but not yet forwarded (gauge)",
    "sbt_serving_batch_fill_ratio": "Real rows / bucket rows per forward (histogram)",
    "sbt_serving_padding_rows_total": "Padding rows added to reach bucket shapes",
    "sbt_serving_compiles_total": "Serving bucket program builds (zero after warmup); on CUDA a build is one CUDA-graph capture",
    "sbt_serving_compile_seconds": "Serving bucket build wall-clock, a graph capture on CUDA (histogram)",
    "sbt_serving_graph_pool_bytes": "Device bytes reserved by an executor's CUDA-graph captures (gauge, label model)",
    "sbt_serving_latency_seconds": "Request latency submit-to-result (histogram; optional path label: direct/coalesced)",
    "sbt_serving_direct_dispatch_total": "Requests served inline by adaptive direct dispatch (idle fast path)",
    "sbt_serving_coalesced_total": "Requests served via the coalescing worker path",
    "sbt_shardmap_traces_total": "shard_map traced executions",
    "sbt_serving_shard_forwards_total": "Slab forwards executed by the replica-sharded (mesh) serving program",
    "sbt_serving_shard_devices": "Replica-axis size of the serving mesh (gauge, set at sharded-executor construction)",
    "sbt_serving_shard_failures_total": "Mesh serving shards marked failed and dropped from the quorum",
    "sbt_serving_degraded": "Executor serves a degraded surviving-replica aggregate (gauge, 0/1)",
    "sbt_serving_degraded_replicas": "Replicas the degraded aggregate averages over (gauge; 0 when healthy)",
    "sbt_serving_degraded_forwards_total": "Slab forwards served by a degraded surviving-subset program",
    "sbt_serving_degraded_compiles_total": "Degraded-program bucket compiles (fault response, not serving compiles)",
    "sbt_program_cache_hits_total": "Unified program cache hits (a build someone already paid, reused)",
    "sbt_program_cache_misses_total": "Unified program cache lookups that found nothing",
    "sbt_program_cache_evictions_total": "Programs evicted from (or dropped by fingerprint from) the unified program cache",
    "sbt_program_cache_entries": "Programs resident in the unified program cache (gauge)",
    "sbt_serving_aot_misses_total": "Persisted executable caches ignored at load (a CUDA graph cannot be deserialized; the live buckets are captured instead)",
    "sbt_serving_overloaded_total": "Requests shed with Overloaded backpressure",
    "sbt_serving_shed_total": "Requests shed at the serving edge (label reason: overload/deadline/degraded)",
    "sbt_serving_retries_total": "Transient micro-batch forward failures retried with backoff",
    "sbt_serving_batch_bisects_total": "Failing coalesced batches split in half to isolate a poisoned request",
    "sbt_serving_request_failures_total": "Requests failed by a forward error after retries and bisect isolation",
    "sbt_serving_worker_crashes_total": "Batcher worker crashes caught by the supervisor",
    "sbt_serving_worker_restarts_total": "Fresh batcher worker threads started by the supervisor (or revive())",
    "sbt_serving_crash_loops_total": "Crash-loop detections that put a batcher into degraded reject mode",
    "sbt_serving_swap_failed_total": "Hot swaps that died building the replacement and rolled back (live executor unchanged)",
    "sbt_faults_armed": "A deterministic fault-injection plan is armed in this process (gauge, 0/1)",
    "sbt_faults_injected_total": "Faults fired by the armed injection plan (labels site, action)",
    "sbt_serving_models_registered_total": "Models registered for serving",
    "sbt_serving_swaps_total": "Successful hot swaps",
    "sbt_serving_swap_rejected_total": "Hot swaps rejected by contract validation",
    "sbt_serving_model_version": "Live model version per registered name (gauge)",
    "sbt_serving_batch_errors_total": "Micro-batches failed by an executor error",
    "sbt_serving_programs_released_total": "Bucket programs dropped by executor release_programs",
    "sbt_profile_captures_total": "On-demand torch.profiler captures started (utils/profiling start_profile, trace())",
    "sbt_profile_rejected_total": "Profile captures rejected by the single-flight guard (one capture per process)",
    "sbt_profile_active": "A device-profile capture is currently running (gauge, 0/1)",
    "sbt_online_updates_total": "Streaming partial_fit steps applied by online updaters (labels as the updater's)",
    "sbt_online_examples_total": "Rows consumed by streaming online updates",
    "sbt_online_oob_rows_total": "Rows scored by the streaming out-of-bag quality tap (Poisson draw 0 replicas)",
    "sbt_online_oob_estimate": "Running streaming OOB quality estimate: accuracy or R2 over OOB-voted rows (gauge)",
    "sbt_quality_rows_total": "Rows folded into the quality plane's live sketches",
    "sbt_quality_psi_max": "Max per-feature PSI of live traffic vs the training reference (gauge)",
    "sbt_quality_psi_mean": "Mean per-feature PSI vs the training reference (gauge)",
    "sbt_quality_ks_max": "Max per-feature binned KS statistic vs the training reference (gauge)",
    "sbt_quality_feature_psi": "Per-feature PSI vs the training reference (gauge, label feature)",
    "sbt_quality_feature_ks": "Per-feature binned KS vs the training reference (gauge, label feature)",
    "sbt_quality_prediction_psi": "PSI of served prediction distribution vs the training reference (gauge)",
    "sbt_quality_confidence_psi": "PSI of served confidence vs the OOB reference (gauge)",
    "sbt_quality_confidence_p50": "P2-sketched median served confidence (gauge)",
    "sbt_quality_refresh_total": "Drift recomputations + gauge exports by quality monitors",
    "sbt_quality_disagreement": "Ensemble disagreement per sampled batch (histogram)",
    "sbt_quality_disagreement_mean": "Running mean ensemble disagreement across sampled batches (gauge)",
    "sbt_quality_disagreement_samples_total": "Batches sampled through the per-replica disagreement tap",
    "sbt_quality_disagreement_compiles_total": "Per-replica tap programs built (one CUDA-graph capture a bucket on the card; separate from serving compiles)",
    "sbt_alerts_fired_total": "Alert rule activations (label rule)",
    "sbt_alerts_resolved_total": "Alert rule resolutions (label rule)",
    "sbt_alerts_suppressed_total": "Alert re-fires suppressed by per-rule cooldown (label rule)",
    "sbt_alerts_evaluations_total": "Alert engine evaluation passes",
    "sbt_alerts_active": "Alert rules currently active (gauge)",
    "sbt_flight_dumps_total": "Flight-recorder dumps written",
    "sbt_flight_dumps_suppressed_total": "Flight-recorder dumps suppressed by cooldown",
    "sbt_online_refits_triggered_total": "Drift-alert refit triggers accepted by the online trainer (label model)",
    "sbt_online_refits_published_total": "Refit candidates that passed validation and were published (swap + checkpoint; label model)",
    "sbt_online_refits_rejected_total": "Refit candidates rejected by validation: scored worse than the incumbent (never published; label model)",
    "sbt_online_refits_skipped_total": "Refit triggers skipped for lack of buffered labeled rows (below min_refit_rows; label model)",
    "sbt_online_refit_errors_total": "Refits that died mid-flight and were absorbed by the trainer's supervision (label model)",
    "sbt_online_refit_seconds": "Wall-clock of one drain->refit->validate->publish cycle (histogram, label model)",
    "sbt_online_buffer_rows": "Labeled rows currently held by one online refit buffer (gauge; label model when attached)",
    "sbt_tenancy_tenants": "Tenants configured in the installed TenantFleet (gauge)",
    "sbt_tenancy_admitted_total": "Requests admitted by the tenancy admission controller (label tenant)",
    "sbt_tenancy_shed_total": "Requests shed by admission policy (labels tenant + reason: quota, priority, or quarantine)",
    "sbt_tenancy_overloads_total": "Downstream Overloaded sheds fed into the admission pressure window",
    "sbt_tenancy_pressure_level": "Admission pressure state: 0 normal / 1 shed batch class / 2 shed standard too (gauge)",
    "sbt_tenancy_demotions_total": "Tenants demoted from residency (programs released, AOT-persisted; label tenant)",
    "sbt_tenancy_restores_total": "Demoted tenants restored from their AOT cache on first hit (label tenant)",
    "sbt_tenancy_resident_tenants": "Tenants currently resident (compiled) under the residency budget (gauge)",
    "sbt_tenancy_pin_violations_total": "Evictions/demotions that had to sacrifice a hot-pinned entry (label tenant, or level=cache)",
    "sbt_tenancy_refit_denied_total": "Online-refit triggers denied by the per-tenant refit budget (label tenant)",
    "sbt_tenancy_latency_p99_ms": "Per-tenant served-request p99 latency in ms (gauge, label tenant; host-band, never digested)",
    "sbt_tenancy_latency_seconds": "Per-tenant served-request wall latency (log-scale histogram, label tenant, exemplar trace ids; bucket counts merge exactly across the fleet)",
    "sbt_tenancy_tail_p99_ms": "p99 latency in ms over the tail tenants - everyone but the Zipf head (gauge; the fleet SLO burn signal)",
    "sbt_tenant_quarantine_trips_total": "Tenants tripped into quarantine by the failure window (unlabeled total + label tenant)",
    "sbt_tenant_quarantine_shed_total": "Requests shed because their tenant is quarantined (unlabeled total + label tenant)",
    "sbt_tenant_quarantine_probes_total": "Single recovery probes admitted for quarantined tenants (label tenant)",
    "sbt_tenant_quarantine_recoveries_total": "Quarantined tenants recovered by a successful probe (label tenant)",
    "sbt_tenant_quarantine_failures_total": "Tenant-attributed failures fed into the quarantine window (labels tenant + kind)",
    "sbt_tenant_quarantine_active": "Tenants currently quarantined or probing (gauge)",
    "sbt_online_refits_budget_denied_total": "Refit triggers dropped by the per-tenant refit budget hook (label model)",
    # the fit report's headline series (telemetry.record_fit_report)
    "sbt_replicas_fitted_total": "Base replicas fitted across all fit calls",
    "sbt_compile_seconds": "XLA compile wall-clock per fit (histogram)",
    "sbt_fit_seconds": "Device fit wall-clock per fit call (histogram)",
    "sbt_h2d_seconds": "Host-to-device transfer seconds per fit (histogram)",
    # the fit, stream and multihost series (bagging.py, streaming.py,
    # tree_stream.py, utils/io.py, utils/prefetch.py,
    # parallel/multihost.py)
    "sbt_h2d_bytes_total": "Bytes transferred host-to-device",
    "sbt_d2h_bytes_total": "Bytes transferred device-to-host",
    "sbt_oob_evaluations_total": "Out-of-bag scoring passes",
    "sbt_collective_seconds": "Multihost collective wall-clock (histogram)",
    "sbt_stream_epochs_total": "Streaming-fit epochs completed",
    "sbt_stream_chunks_total": "Streaming-fit chunks consumed",
    "sbt_chunks_yielded_total": "Chunks yielded by streaming sources",
    "sbt_chunk_seconds": "Per-chunk step wall-clock (histogram)",
    "sbt_prefetch_queue_depth": "Prefetch queue depth (gauge)",
    "sbt_prefetch_stall_seconds_total": "Seconds the consumer stalled on prefetch",
    # the boosting learners (models/gbt.py), once a learner fit
    "sbt_gbt_rounds_total": "Boosting rounds run by GBT learner fits (one count a round of a replica chunk)",
    "sbt_gbt_trees_total": "Trees grown by GBT learner fits (a tree a replica, or a replica's class, each round)",
    # per-bucket forward cost: FLOPs counted at the bucket's build, bytes
    # as every input read once and the output written once
    "sbt_serving_bucket_cost_flops": "Compiled FLOPs per forward at this bucket (gauge, label bucket)",
    "sbt_serving_bucket_cost_bytes": "Compiled bytes accessed per forward at this bucket (gauge, label bucket)",
    "sbt_serving_flops_total": "FLOPs dispatched by serving forwards (cost-analysis attributed)",
    "sbt_serving_padding_flops_total": "FLOPs spent on padding rows (waste, cost-analysis attributed)",
    # the exposition server's process gauges, sampled at scrape
    "sbt_process_uptime_seconds": "Seconds since the exposition server started (gauge)",
    "sbt_process_rss_bytes": "Resident set size of this process (gauge, sampled at scrape)",
    "sbt_process_device_bytes_in_use": "Device memory currently allocated, where the backend reports it (gauge, label device)",
    "sbt_process_device_bytes_limit": "Device memory capacity, where the backend reports it (gauge, label device)",
    "sbt_process_device_peak_bytes": "Peak device memory allocated since process start, where reported (gauge, label device)",
    # the fleet plane (telemetry/fleet.py)
    "sbt_fleet_peers": "Peer processes configured on the fleet aggregator (gauge)",
    "sbt_fleet_peers_fresh": "Peers whose latest scrape succeeded and is within the staleness bound (gauge)",
    "sbt_fleet_peers_stale": "Peers excluded from the merge/quorum: failed or overdue last scrape (gauge)",
    "sbt_fleet_quorum": "Fleet quorum health: 1 healthy, 0 lost (gauge; degraded still counts 1)",
    "sbt_fleet_scrapes_total": "Peer scrape attempts by the fleet aggregator",
    "sbt_fleet_scrape_failures_total": "Peer scrapes that failed (timeout/HTTP error; label process)",
    "sbt_fleet_scrape_age_seconds": "Seconds since the last successful scrape of a peer (gauge, label process)",
    "sbt_fleet_merged_series": "Peer-derived series in the latest merge, before the fleet-synthesized sbt_fleet_* series are appended (gauge)",
    "sbt_fleet_merge_conflicts_total": "Series dropped from a merge because peers disagree on kind or histogram bounds",
    "sbt_fleet_version": "Live model version reported by one peer (gauge, labels model+process)",
    "sbt_fleet_version_skew": "Max minus min live model version across fresh peers (gauge, label model; 0 = converged)",
    "sbt_fleet_convergence_seconds": "Rolling-swap convergence time: version skew rising above 0 until back to 0 (histogram, label model)",
    # the performance-attribution plane (telemetry/perf.py)
    "sbt_perf_stage_seconds": "Per-request wall-clock attributed to one pipeline stage (histogram, labels stage + path, or stage + tenant over the full journey: admission/wfq/restore/dispatch/queue/forward/scatter)",
    "sbt_perf_stage_share": "Share of total request wall-clock spent in one stage (gauge, labels stage + path, or stage + tenant for the journey twin)",
    "sbt_perf_bucket_seconds_per_row": "Measured forward seconds per served row at this bucket (gauge, label bucket — the live cost model)",
    "sbt_perf_bucket_achieved_flops": "Achieved FLOP/s of this bucket's forward: compiled FLOPs over measured seconds (gauge, label bucket)",
    "sbt_perf_mfu": "Serving model-FLOPs utilization: achieved FLOP/s over the device bf16 peak (gauge; absent on unknown device kinds)",
    "sbt_perf_dropped_total": "Perf-attribution observations dropped by the fixed-memory key cap",
    # the longitudinal history store (telemetry/history.py)
    "sbt_history_appends_total": "Records appended to the longitudinal history store (telemetry_dir()/history/history.jsonl)",
    "sbt_history_records": "Records seen by the latest history trend scan (gauge)",
    "sbt_history_groups": "Distinct (kind, key) groups in the latest history trend scan (gauge)",
    "sbt_history_digest_flips": "Digest/SLO flips found by the latest history trend scan (gauge; any nonzero is a regression finding)",
    "sbt_history_numeric_drift": "Numeric fields outside the CI-noise band in the latest history trend scan (gauge, advisory)",
    # the capacity plane (telemetry/capacity.py) and the program cache's bytes
    "sbt_program_cache_bytes": "Measured executable bytes resident in the unified program cache (gauge; unmeasured entries excluded, see sbt_capacity_unmeasured_entries)",
    "sbt_capacity_params_bytes": "Stacked-pytree parameter bytes held by one committed (model, version) (gauge, labels model+version)",
    "sbt_capacity_compiled_bytes": "Measured program-cache executable bytes attributed to one committed model (gauge, label model)",
    "sbt_capacity_resident_entries": "Program-cache entries attributed to one committed model (gauge, label model)",
    "sbt_capacity_unmeasured_entries": "Resident entries whose executable bytes could not be measured - flagged, never counted as 0 (gauge, label model)",
    "sbt_capacity_models": "Distinct models in the capacity ledger (gauge)",
    "sbt_capacity_demand_requests_total": "Requests served per model, fed from the packed-forward demand tap (label model)",
    "sbt_capacity_demand_rows_total": "Rows served per model, fed from the packed-forward demand tap (label model)",
    "sbt_capacity_demand_rate_rps": "Per-model request rate over the last classification window (gauge, label model)",
    "sbt_capacity_demand_rank": "Per-model popularity rank by cumulative requests, 1 = hottest (gauge, label model)",
    "sbt_capacity_demand_class": "Per-model demand class with hysteresis: 2 hot / 1 warm / 0 cold (gauge, label model)",
    "sbt_capacity_demand_dropped_total": "Demand observations dropped by the fixed-memory model cap (capacity plane max_models)",
    "sbt_capacity_cache_headroom_ratio": "Free-slot ratio of the program cache: (capacity - entries) / capacity (gauge)",
    "sbt_capacity_cold_resident_entries": "Program-cache entries owned by cold-demand-class models (gauge; the reclaim candidates)",
}


def _help_for(name: str) -> str | None:
    text = SERIES_HELP.get(name)
    if text is None and name.startswith("sbt_fit_"):
        key = name[len("sbt_fit_"):]
        text = f"fit_report_[{key!r}] exported as a gauge"
    return text

# The quantiles every histogram surfaces (snapshot/dump/varz/serving
# stats): median, tail, far tail — the serve-SLO trio.
QUANTILES: tuple[float, ...] = (0.5, 0.95, 0.99)


def _label_key(labels: dict[str, Any] | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-write-wins value (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Log-scale bucketed distribution (Prometheus ``histogram``).

    Buckets store per-bucket counts; cumulative ``le`` counts are
    produced at render time (the exposition format's convention).
    ``observe(v, exemplar=...)`` additionally remembers the most
    recent exemplar (a trace id) per bucket, so a latency spike in the
    p99 bucket comes with a concrete request to go look up in the
    span log — the histogram-to-trace jump of OpenMetrics exemplars.

    Alongside newest-wins, a small **top-K-by-value reservoir**
    (``slow_exemplars``, :data:`RESERVOIR_K` entries) retains the
    LARGEST observations seen: newest-per-bucket alone would hand the
    tail explainer (``/debug/tail``) mostly fresh fast requests —
    under steady traffic the slow outlier that defined the p99 is
    evicted from its bucket within seconds. The rule is deterministic
    (a strictly greater value evicts the current minimum; ties keep
    the incumbent) and O(K) under the registry lock the observe
    already holds.
    """

    kind = "histogram"

    #: top-K-by-duration exemplar reservoir size (per histogram)
    RESERVOIR_K = 4

    def __init__(self, buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        self.bounds = tuple(sorted(buckets))
        if not self.bounds or self.bounds[-1] != math.inf:
            self.bounds = self.bounds + (math.inf,)
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0
        # bucket index -> {"trace_id", "value", "ts"} (last write wins:
        # the freshest example of that latency class is the useful one)
        self.exemplars: dict[int, dict[str, Any]] = {}
        # unordered top-K-by-value entries, same shape as exemplars
        self.slow_exemplars: list[dict[str, Any]] = []

    def observe(self, v: float, exemplar: str | None = None) -> None:
        v = float(v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                if exemplar is not None:
                    entry = {
                        "trace_id": exemplar, "value": v,
                        "ts": time.time(),
                    }
                    self.exemplars[i] = entry
                    slow = self.slow_exemplars
                    if len(slow) < self.RESERVOIR_K:
                        slow.append(dict(entry))
                    else:
                        m = min(range(len(slow)),
                                key=lambda j: slow[j]["value"])
                        if v > slow[m]["value"]:
                            slow[m] = dict(entry)
                break
        # count AFTER the bucket: quantile() reads the live object
        # without the registry lock (stats paths), in the opposite
        # order — count first, then the counts copy — so a concurrent
        # reader can never see count > sum(counts)
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile by log-linear interpolation
        inside the bucket where the cumulative count crosses it.

        The grid is log-scale (decades by default), so interpolating
        in log space matches the distribution model the buckets
        already impose; the first bucket interpolates from one decade
        below its bound, and mass in the ``+Inf`` bucket clamps to the
        last finite bound (the estimate is a floor there — say so in
        dashboards). NaN when empty.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        # lock-free read off the live object (MicroBatcher.stats() and
        # /varz call this while the worker observes under the registry
        # lock): read count BEFORE copying counts — paired with
        # observe()'s bucket-before-count write order this guarantees
        # sum(counts) >= count, so the loop always crosses target
        count = self.count
        counts = list(self.counts)
        if count == 0:
            return math.nan
        target = q * count
        cum = 0
        for i, (b, c) in enumerate(zip(self.bounds, counts)):
            cum += c
            if cum >= target and c > 0:
                if not math.isfinite(b):
                    # beyond the grid: the last finite bound is all we
                    # can honestly claim
                    return self.bounds[i - 1] if i > 0 else math.inf
                lo = self.bounds[i - 1] if i > 0 else b / 10.0
                if lo <= 0:
                    lo = b / 10.0
                frac = (target - (cum - c)) / c
                return lo * (b / lo) ** frac
        return math.nan  # pragma: no cover — cum == count >= target

    def quantiles(self) -> dict[str, float | None]:
        """The standard trio (p50/p95/p99) as a JSON-friendly dict.
        Non-finite estimates (empty histogram) become None — `NaN` is
        not JSON, and these dicts land verbatim in /varz responses,
        flight dumps, and capture() metrics snapshots."""
        out: dict[str, float | None] = {}
        for q in QUANTILES:
            v = self.quantile(q)
            out[f"p{int(q * 100)}"] = v if math.isfinite(v) else None
        return out

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram EXACTLY —
        bucket-wise count addition, so the merged histogram is
        indistinguishable from one that observed the concatenation of
        both observation streams (same bucket counts ⇒ same quantile
        estimates: the fleet aggregator's no-percentile-averaging
        guarantee rides on this). Requires identical bucket bounds —
        two grids cannot be combined without losing exactness, so a
        mismatch raises instead of approximating. Exemplars adopt the
        newer entry per bucket (last-write-wins, matching
        :meth:`observe`); the slow reservoirs merge by the reservoir's
        own rule — the K largest values across both peers win (ties
        broken toward the newer ``ts``), so the fleet view's tail
        exemplars are exactly the fleet's slowest requests. Returns
        ``self``."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} buckets)"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        for i, ex in other.exemplars.items():
            mine = self.exemplars.get(i)
            if mine is None or ex.get("ts", 0) >= mine.get("ts", 0):
                self.exemplars[i] = dict(ex)
        pool = self.slow_exemplars + [dict(e) for e in
                                      other.slow_exemplars]
        pool.sort(key=lambda e: (-e.get("value", 0.0),
                                 -e.get("ts", 0.0)))
        self.slow_exemplars = pool[:self.RESERVOIR_K]
        return self


# sbt-lint: shared-state
class Registry:
    """Thread-safe metric store keyed by ``(name, labels)``."""

    def __init__(self) -> None:
        self._lock = make_lock("telemetry.registry")
        self._metrics: dict[tuple[str, tuple], Any] = {}

    def _get_locked(self, name: str, labels, cls):
        """Fetch-or-create under the ALREADY-HELD lock."""
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            # sbt-lint: disable=shared-state-unlocked — every caller holds self._lock (enforced by the _locked naming convention)
            m = self._metrics[key] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}"
            )
        return m

    def peek(self, name: str, labels: dict | None = None):
        """The live metric object for ``(name, labels)``, or None —
        a read that never CREATES the series. The alert engine samples
        series it does not own; materializing them at 0.0 would make
        "absent" and "zero" indistinguishable (an ``op "<"`` rule
        would page on data that was never written)."""
        with self._lock:
            return self._metrics.get((name, _label_key(labels)))

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        with self._lock:
            return self._get_locked(name, labels, Counter)

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        with self._lock:
            return self._get_locked(name, labels, Gauge)

    def histogram(self, name: str, labels: dict | None = None) -> Histogram:
        with self._lock:
            return self._get_locked(name, labels, Histogram)

    # convenience mutators (one lock round-trip each; call sites stay
    # one-liners behind the enabled() gate)

    def inc(self, name: str, v: float = 1.0, labels: dict | None = None) -> None:
        with self._lock:
            self._get_locked(name, labels, Counter).inc(v)

    def inc_many(self, items: Iterable[tuple[str, float]]) -> None:
        """Increment several (unlabeled) counters under ONE lock
        round-trip — the serving hot path counts 4+ series per
        forward, and per-call lock acquisitions were measurable
        there."""
        with self._lock:
            for name, v in items:
                self._get_locked(name, None, Counter).inc(v)

    def set(self, name: str, v: float, labels: dict | None = None) -> None:
        with self._lock:
            self._get_locked(name, labels, Gauge).set(v)

    def observe(self, name: str, v: float, labels: dict | None = None,
                exemplar: str | None = None) -> None:
        with self._lock:
            self._get_locked(name, labels, Histogram).observe(
                v, exemplar=exemplar
            )

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self, *, quantiles: bool = False) -> list[dict]:
        """JSON-serializable dump of every metric (the ``metrics``
        JSONL event body, and the input to :func:`render_prometheus`).

        ``quantiles=True`` adds interpolated p50/p95/p99 to each
        histogram entry; the default skips that work because the two
        hottest callers — the ``/metrics`` scrape and the JSONL
        metrics flush — never read them (consumers of a bare snapshot
        can always reconstruct via :func:`snapshot_quantiles`, the
        bucket counts are in the entry)."""
        out = []
        with self._lock:
            for (name, labels), m in sorted(self._metrics.items()):
                if m.kind == "histogram":
                    entry = histogram_entry(name, dict(labels), m)
                else:
                    entry = {
                        "name": name,
                        "kind": m.kind,
                        "labels": dict(labels),
                        "value": m.value,
                    }
                out.append(entry)
        # quantile interpolation happens OUTSIDE the lock, from each
        # entry's copied bucket counts — every metric writer blocks on
        # this lock
        if quantiles:
            for entry in out:
                if entry["kind"] == "histogram":
                    entry["quantiles"] = snapshot_quantiles(entry)
        return out


def _escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, and
    newline must be escaped or the sample line is unparseable (a model
    name like ``c:\\models`` or ``he said "v2"`` would tear the whole
    scrape otherwise). Order matters: backslash first."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP text escaping per the exposition format: backslash and
    newline only (quotes are legal there)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    # non-finite first: int(NaN)/int(inf) raise, and a diverged fit's
    # loss_mean=NaN must not take the instrument panel down with it
    # (Prometheus text spec spells these NaN/+Inf/-Inf)
    if not math.isfinite(f):
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def histogram_entry(name: str, labels: dict, h: Histogram) -> dict:
    """Serialize one histogram as a snapshot entry — the JSON shape
    :meth:`Registry.snapshot` emits and :func:`histogram_from_entry`
    inverts. One serializer for both the live registry and the fleet
    merge (a shape drift between them would silently break the
    ``dump --merge`` / ``/fleet/varz`` round-trip)."""
    entry: dict[str, Any] = {
        "name": name,
        "kind": "histogram",
        "labels": dict(labels),
        "buckets": [
            ["+Inf" if b == math.inf else b, c]
            for b, c in zip(h.bounds, h.counts)
        ],
        "sum": h.sum,
        "count": h.count,
    }
    if h.exemplars:
        entry["exemplars"] = [
            {
                "le": "+Inf" if h.bounds[i] == math.inf else h.bounds[i],
                **ex,
            }
            for i, ex in sorted(h.exemplars.items())
        ]
    if h.slow_exemplars:
        entry["slow_exemplars"] = sorted(
            (dict(ex) for ex in h.slow_exemplars),
            key=lambda e: (-e.get("value", 0.0), -e.get("ts", 0.0)),
        )
    return entry


def histogram_from_entry(entry: dict) -> Histogram:
    """Reconstruct a live :class:`Histogram` from one snapshot entry
    (the JSON shape :meth:`Registry.snapshot` emits). The exemplar list
    is folded back keyed by bucket index so round-tripped histograms
    merge like live ones."""
    h = Histogram(buckets=[
        math.inf if b == "+Inf" else float(b)
        for b, _ in entry["buckets"]
    ])
    h.counts = [int(c) for _, c in entry["buckets"]]
    h.count = int(entry["count"])
    h.sum = float(entry["sum"])
    bound_index = {b: i for i, b in enumerate(h.bounds)}
    for ex in entry.get("exemplars", ()):
        le = ex.get("le")
        i = bound_index.get(math.inf if le == "+Inf" else float(le))
        if i is not None:
            h.exemplars[i] = {k: v for k, v in ex.items() if k != "le"}
    h.slow_exemplars = [dict(ex) for ex in
                        entry.get("slow_exemplars", ())]
    return h


def snapshot_quantiles(entry: dict) -> dict[str, float]:
    """p50/p95/p99 for one histogram snapshot entry. Live snapshots
    carry them precomputed; entries read back from an old JSONL log
    are reconstructed from their bucket counts (same interpolation)."""
    if "quantiles" in entry:
        return entry["quantiles"]
    return histogram_from_entry(entry).quantiles()


def render_prometheus(snapshot: list[dict]) -> str:
    """Prometheus text exposition of a :meth:`Registry.snapshot`.

    Series with an entry in :data:`SERIES_HELP` (or an ``sbt_fit_*``
    name) get a ``# HELP`` line ahead of their ``# TYPE``, once per
    metric name. Label values are escaped per the format spec.
    """
    lines: list[str] = []
    seen_type: set[str] = set()
    for entry in snapshot:
        name, kind, labels = entry["name"], entry["kind"], entry["labels"]
        if name not in seen_type:
            help_text = _help_for(name)
            if help_text is not None:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {kind}")
            seen_type.add(name)
        if kind == "histogram":
            cum = 0
            for le, c in entry["buckets"]:
                cum += c
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(labels, {'le': le})} {cum}"
                )
            lines.append(
                f"{name}_sum{_fmt_labels(labels)} "
                f"{_fmt_value(entry['sum'])}"
            )
            lines.append(
                f"{name}_count{_fmt_labels(labels)} {entry['count']}"
            )
        else:
            lines.append(
                f"{name}{_fmt_labels(labels)} {_fmt_value(entry['value'])}"
            )
    return "\n".join(lines) + ("\n" if lines else "")
