"""Fleet observability plane — N processes, one merged pane of glass.

Serving is N-process (``serve_config.json`` manifests,
version-consistent rolling swaps) and each process survives faults,
but every other observability surface is single-process: one
registry, one ``/varz``, one flight recorder. This module is the
divide-and-merge half — the same aggregation structure bagging itself
rests on (*A Scalable Bootstrap for Massive Data*, arxiv 1112.5016):
each peer computes its own complete statistics, and a pull-based
:class:`FleetAggregator` merges them EXACTLY rather than averaging
summaries.

**Merge semantics** (:func:`merge_snapshots` — also the offline
``python -m spark_bagging_tpu_torch.telemetry dump --merge`` code path):

- **counters** sum across fresh peers (same name + labels);
- **gauges** keep per-peer values under a ``process=`` label and gain
  ``fleet="min"/"max"/"sum"`` aggregate series (a fleet-wide queue
  depth is three different questions — worst peer, best peer, total —
  and collapsing them to one number answers none);
- **histograms** merge bucket-wise via :meth:`Histogram.merge` —
  exact by construction, so fleet p50/p95/p99 are computed from the
  union of the peers' bucket counts. Percentiles are NEVER averaged
  (the mean of two p99s is not a p99 of anything).

Peers are scraped over their exposition endpoint (``/varz`` JSON,
loopback HTTP — :class:`HTTPPeer`) or in-process
(:class:`RegistryPeer`: the unit-test and virtual-fleet seam).
A peer whose scrape times out or errors is marked **stale**: excluded
from quorum and from gauge merges (a stale queue depth is a stale
lie), while its CUMULATIVE series — counters, histograms — stay in
the merge frozen at their last-known values (a counter is a lower
bound that never lies, and dropping it would make the merged sum
non-monotonic: the peer's history would vanish and reappear on
recovery, which a rate rule reads as a failure spike). A stale peer
is never merged as zeros — absent data is not zero data — and its
outage is visible as ``sbt_fleet_scrape_age_seconds`` plus a counted
``sbt_fleet_scrape_failures_total``. Quorum health mirrors the
serving plane's degraded semantics: majority of peers fresh+healthy ⇒ quorum holds
(``degraded`` when any peer is lost), below majority ⇒ ``/fleet/
healthz`` serves 503.

**Swap convergence** is first-class: per-peer live versions surface as
``sbt_fleet_version{model=,process=}``, ``sbt_fleet_version_skew`` is
max−min across the peers' LAST-KNOWN versions (0 = converged; the
unlabeled twin is the max over models, what
:func:`default_fleet_rules`' skew-stalled rule watches) — last-known,
not fresh-only, so a peer that wedges mid-upgrade and stops answering
scrapes holds the excursion open instead of faking convergence — and
each skew excursion's duration lands in the
``sbt_fleet_convergence_seconds`` histogram — time-to-convergence of
a rolling swap, measured not inferred.

**Incidents**: :func:`correlate_incidents` flattens the peers' flight
feeds (dump records + ring trigger events, scraped with ``/varz``)
plus the aggregator's own alert firings into one time-ordered
timeline and groups same-trigger events inside a correlation window
into single incidents — the "did peer 1's flight dump line up with
peer 3's shed burst?" view, served at ``/fleet/incidents``.

Everything is clock-injectable (``tick(now=...)``) and thread-free:
scrapes run when a ``/fleet/*`` route (or a virtual-clock drill) ticks
the aggregator, which is what lets a replayed fleet assert
byte-identical merged digests, skew transcripts, and incident
timelines across repeats.

The port's copy of the JAX package's ``telemetry/fleet.py``: a port
process and a JAX process scrape and merge each other's ``/varz``
alike.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Iterable

from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.telemetry.registry import (
    Histogram,
    _label_key,
    histogram_entry,
    histogram_from_entry,
    snapshot_quantiles,
)
from spark_bagging_tpu_torch.telemetry.state import STATE

#: the deterministic plane of a merged snapshot: series whose values
#: are a pure function of (workload, seed, plan) under the virtual
#: clock — what a replayed fleet's digest covers. Wall-clock
#: series (latencies, compile seconds, process RSS) and cache-state-
#: dependent counters (compiles: the program cache makes repeat 1
#: compile and repeat 2 adopt) are deliberately excluded.
FLEET_DIGEST_SERIES: tuple[str, ...] = (
    "sbt_serving_requests_total",
    "sbt_serving_rows_total",
    "sbt_serving_batches_total",
    "sbt_serving_padding_rows_total",
    "sbt_serving_batch_fill_ratio",
    "sbt_serving_shed_total",
    "sbt_serving_overloaded_total",
    "sbt_serving_request_failures_total",
    "sbt_serving_retries_total",
    "sbt_serving_batch_bisects_total",
    "sbt_serving_model_version",
    "sbt_serving_swaps_total",
    "sbt_fleet_peers",
    "sbt_fleet_peers_fresh",
    "sbt_fleet_peers_stale",
    "sbt_fleet_quorum",
    "sbt_fleet_scrapes_total",
    "sbt_fleet_scrape_failures_total",
    "sbt_fleet_scrape_age_seconds",
    "sbt_fleet_version",
    "sbt_fleet_version_skew",
    "sbt_fleet_convergence_seconds",
    # capacity plane: demand counters are workload-pure
    # (fed per packed batch under the virtual clock); the byte gauges
    # are toolchain-dependent measurements and stay out of the digest
    "sbt_capacity_demand_requests_total",
    "sbt_capacity_demand_rows_total",
)


@contextmanager
def use_registry(registry):
    """Temporarily install ``registry`` as THE process metrics registry
    — the seam that lets one process simulate N: a virtual-fleet drill
    drives each virtual peer's batcher/model-registry inside its own
    ``use_registry(reg_i)`` scope, so every ``sbt_*`` series lands in
    that peer's registry exactly as it would in a real peer process.
    Single-threaded virtual-clock drills only: the swap is a plain
    module-global write, visible to every thread."""
    prev = STATE.registry
    STATE.registry = registry
    try:
        yield registry
    finally:
        STATE.registry = prev


def _emit(event: dict) -> None:
    if STATE.enabled and STATE._sinks:
        event.setdefault("ts", time.time())
        STATE.emit(event)


# -- peers ---------------------------------------------------------------

class HTTPPeer:
    """A peer process scraped over its exposition endpoint: one
    ``GET <base_url>/varz`` per scrape (metrics + health + flight feed
    in a single round-trip). Timeouts and HTTP errors raise — the
    aggregator turns them into staleness, never into zeros.
    ``remote = True`` tells the aggregator this scrape does network
    I/O, so a pass scrapes it concurrently with the other remote
    peers — N dead peers cost ONE timeout, not N stacked ones."""

    remote = True

    def __init__(self, name: str, base_url: str, *,
                 timeout_s: float = 2.0) -> None:
        self.name = str(name)
        self.base_url = str(base_url).rstrip("/")
        self.timeout_s = float(timeout_s)

    def scrape(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(
            self.base_url + "/varz", timeout=self.timeout_s
        ) as resp:
            if resp.status != 200:
                raise RuntimeError(
                    f"peer {self.name!r} /varz returned {resp.status}"
                )
            return json.loads(resp.read().decode("utf-8"))

    def __repr__(self) -> str:
        return f"HTTPPeer({self.name!r}, {self.base_url!r})"


class RegistryPeer:
    """An in-process peer: a bare :class:`telemetry.registry.Registry`
    (plus optional health callable and flight recorder) dressed up as
    a scrape target. The unit-test and virtual-fleet seam — the
    virtual-fleet drill gives each simulated peer one of these."""

    def __init__(self, name: str, registry, *,
                 health: Callable[[], dict] | None = None,
                 recorder=None) -> None:
        self.name = str(name)
        self._registry = registry
        self._health = health
        self._recorder = recorder

    def scrape(self) -> dict:
        out: dict[str, Any] = {"metrics": self._registry.snapshot()}
        if self._health is not None:
            out["health"] = dict(self._health())
        if self._recorder is not None:
            out["flight"] = self._recorder.timeline_feed()
        return out

    def __repr__(self) -> str:
        return f"RegistryPeer({self.name!r})"


# -- the exact merge -----------------------------------------------------

def _value_entry(name: str, kind: str, labels: dict, v: float) -> dict:
    return {"name": name, "kind": kind, "labels": dict(labels),
            "value": v}


def _entry_sort_key(e: dict):
    return (e["name"], tuple(sorted(e["labels"].items())))


def merge_snapshots(
    named_snapshots: Iterable[tuple[str, list[dict]]],
) -> tuple[list[dict], list[str]]:
    """Merge per-process registry snapshots into one fleet snapshot.

    ``named_snapshots`` is ``[(process_name, snapshot_entries), ...]``
    where each snapshot is the :meth:`Registry.snapshot` JSON shape.
    Returns ``(merged_entries, dropped_names)``: counters summed,
    gauges per-peer ``process=``-labeled plus ``fleet=min/max/sum``
    aggregates, histograms merged bucket-wise (exact). A series whose
    peers disagree on metric kind or histogram bounds cannot be merged
    exactly and is dropped whole — its names come back in
    ``dropped_names`` so callers can count the conflict instead of
    publishing a lie."""
    counters: dict[tuple, float] = {}
    gauges: dict[tuple, list[tuple[str, float]]] = {}
    hists: dict[tuple, Histogram] = {}
    kinds: dict[tuple, str] = {}
    dropped_keys: set[tuple] = set()
    for pname, snap in named_snapshots:
        for e in snap:
            name = e["name"]
            labels = e.get("labels") or {}
            key = (name, _label_key(labels), )
            if key in dropped_keys:
                continue
            kind = e["kind"]
            prev = kinds.setdefault(key, kind)
            if prev != kind:
                dropped_keys.add(key)
                continue
            if kind == "counter":
                counters[key] = counters.get(key, 0.0) + float(e["value"])
            elif kind == "gauge":
                if "process" in labels or "fleet" in labels:
                    # the merge OWNS these two label names on gauges;
                    # a pre-labeled series (e.g. re-merging an already
                    # merged snapshot) would silently collide into
                    # duplicate-label entries — a conflict, like
                    # kind/bounds disagreements, never a quiet lie
                    dropped_keys.add(key)
                    continue
                gauges.setdefault(key, []).append(
                    (str(pname), float(e["value"]))
                )
            else:
                h = histogram_from_entry(e)
                mine = hists.get(key)
                if mine is None:
                    hists[key] = h
                else:
                    try:
                        mine.merge(h)
                    except ValueError:
                        dropped_keys.add(key)
    for key in dropped_keys:
        counters.pop(key, None)
        gauges.pop(key, None)
        hists.pop(key, None)
    out: list[dict] = []
    for (name, lk), v in counters.items():
        out.append(_value_entry(name, "counter", dict(lk), v))
    for (name, lk), per_peer in gauges.items():
        labels = dict(lk)
        values = [v for _, v in per_peer]
        for pname, v in per_peer:
            out.append(_value_entry(
                name, "gauge", {**labels, "process": pname}, v
            ))
        for agg, v in (("min", min(values)), ("max", max(values)),
                       ("sum", sum(values))):
            out.append(_value_entry(
                name, "gauge", {**labels, "fleet": agg}, v
            ))
    for (name, lk), h in hists.items():
        out.append(histogram_entry(name, dict(lk), h))
    out.sort(key=_entry_sort_key)
    return out, sorted({name for name, _ in dropped_keys})


def merged_digest(entries: list[dict],
                  series: Iterable[str] | None = FLEET_DIGEST_SERIES,
                  ) -> str:
    """Canonical sha256 of a merged snapshot's deterministic plane.
    ``series`` is an inclusion list (None = everything); exemplars are
    stripped — they carry wall-clock timestamps and process-global
    trace ids, which are real data but not run-stable identity."""
    include = set(series) if series is not None else None
    keep = []
    for e in entries:
        if include is not None and e["name"] not in include:
            continue
        keep.append({k: v for k, v in e.items()
                     if k not in ("exemplars", "slow_exemplars")})
    keep.sort(key=_entry_sort_key)
    return hashlib.sha256(
        json.dumps(keep, sort_keys=True).encode()
    ).hexdigest()


# -- incident correlation ------------------------------------------------

def correlate_incidents(
    feeds: Iterable[tuple[str, dict | None]],
    *,
    window_s: float = 5.0,
    clock_key: str = "ts",
) -> tuple[list[dict], list[dict]]:
    """Order the peers' incident feeds into one timeline and group
    same-trigger events into incidents.

    Each feed is the ``flight`` section a peer's ``/varz`` exposes
    (:meth:`FlightRecorder.timeline_feed`): ``dumps`` records and ring
    ``events``. Events are stamped from ``clock_key`` — ``"ts"``
    (wall clock; production, where all peers share one host clock) or
    ``"now"`` (the alert engine's injectable clock; what a virtual
    drill uses for byte-stable timelines). Entries without that stamp
    are excluded rather than mixed across clocks.

    Grouping: events sharing a trigger identity — ``(kind, key)``
    where key is the alert rule / model / kind — chain into one
    incident while each is within ``window_s`` of the incident's last
    event. Returns ``(incidents, flat_events)``, both time-ordered;
    the flat timeline is what lets an operator line a flight dump on
    one peer up against sheds on another even when they are distinct
    incidents."""
    flat: list[dict] = []
    for peer, feed in feeds:
        if not feed:
            continue
        for d in feed.get("dumps", ()):
            t = d.get(clock_key)
            if t is None:
                continue
            kind = d.get("kind") or "flight_dump"
            flat.append({
                "t": float(t), "peer": str(peer), "kind": kind,
                "key": d.get("rule") or d.get("model") or kind,
                "type": "flight_dump", "path": d.get("path"),
            })
        for ev in feed.get("events", ()):
            t = ev.get(clock_key)
            if t is None:
                continue
            kind = ev.get("kind") or "event"
            entry = {
                "t": float(t), "peer": str(peer), "kind": kind,
                "key": ev.get("rule") or ev.get("model") or kind,
                "type": "event",
            }
            for k in ("rule", "model", "severity", "value", "version",
                      "trace_id"):
                if k in ev:
                    entry[k] = ev[k]
            flat.append(entry)
    flat.sort(key=lambda e: (e["t"], e["peer"], e["kind"],
                             str(e["key"])))
    incidents: list[dict] = []
    open_by_key: dict[tuple, dict] = {}
    for e in flat:
        gk = (e["kind"], str(e["key"]))
        inc = open_by_key.get(gk)
        if inc is None or e["t"] - inc["t_end"] > window_s:
            inc = {
                "kind": e["kind"], "key": e["key"],
                "t_start": e["t"], "t_end": e["t"],
                "peers": [], "count": 0, "events": [],
            }
            incidents.append(inc)
            open_by_key[gk] = inc
        inc["t_end"] = e["t"]
        inc["count"] += 1
        if e["peer"] not in inc["peers"]:
            inc["peers"].append(e["peer"])
        inc["events"].append(e)
    incidents.sort(key=lambda i: (i["t_start"], i["kind"],
                                  str(i["key"])))
    return incidents, flat


def timeline_digest(incidents: list[dict]) -> str:
    """sha256 over the deterministic projection of a timeline — the
    identity the ``--fleet`` drill asserts across repeats."""
    proj = [
        [i["kind"], str(i["key"]), sorted(i["peers"]), i["count"],
         round(i["t_start"], 9), round(i["t_end"], 9)]
        for i in incidents
    ]
    return hashlib.sha256(
        json.dumps(proj, sort_keys=True).encode()
    ).hexdigest()


# -- the aggregator ------------------------------------------------------

class _Sample:
    """What :meth:`FleetAggregator.peek` hands the alert engine: the
    merged series' kind + value (counters/gauges only — rules never
    sample histograms)."""

    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: float) -> None:
        self.kind = kind
        self.value = value


class _PeerStatus:
    __slots__ = ("name", "ok", "error", "last_attempt_t", "last_ok_t",
                 "failures", "snapshot")

    def __init__(self, name: str) -> None:
        self.name = name
        self.ok: bool | None = None      # None = never scraped
        self.error: str | None = None
        self.last_attempt_t: float | None = None
        self.last_ok_t: float | None = None
        self.failures = 0
        self.snapshot: dict | None = None  # last SUCCESSFUL /varz


# sbt-lint: shared-state
class FleetAggregator:
    """Pull-based scrape-and-merge over N peers (see module doc).

    Clock-injectable and thread-free: call :meth:`tick` from a scrape
    handler, a loop, or a virtual clock. ``interval_s`` rate-
    limits real scrapes (a tight ``curl`` loop on ``/fleet/metrics``
    must not hammer every peer); ``tick(force=True)`` bypasses it.
    ``rules`` (e.g. :func:`default_fleet_rules`) install an
    :class:`~spark_bagging_tpu_torch.telemetry.alerts.AlertEngine` sampling
    the MERGED series via :meth:`peek`, evaluated once per scrape
    pass on the same injected clock.
    """

    def __init__(
        self,
        peers: Iterable[HTTPPeer | RegistryPeer],
        *,
        interval_s: float = 5.0,
        stale_after_s: float | None = None,
        quorum: int | None = None,
        correlation_window_s: float = 5.0,
        rules: Iterable | None = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.peers = tuple(peers)
        if not self.peers:
            raise ValueError("a fleet aggregator needs at least one peer")
        names = [p.name for p in self.peers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate peer names: {sorted(names)}")
        if quorum is not None and not 1 <= quorum <= len(self.peers):
            raise ValueError(
                f"quorum must be in [1, {len(self.peers)}], got {quorum}"
            )
        self.interval_s = float(interval_s)
        # staleness by AGE, for when ticks keep running but one peer's
        # last success recedes into the past; a FAILED last attempt
        # marks the peer stale immediately (the serving plane's stance: degrade
        # on the fault, heal on the next success)
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else max(3.0 * self.interval_s, 10.0))
        self.quorum = (int(quorum) if quorum is not None
                       else len(self.peers) // 2 + 1)
        self.correlation_window_s = float(correlation_window_s)
        self._clock = clock
        # _scrape_lock serializes whole scrape passes (network I/O
        # outside _lock); _lock guards the merged state. Order is
        # always _scrape_lock -> _lock.
        self._scrape_lock = make_lock("telemetry.fleet.scrape")
        self._lock = make_lock("telemetry.fleet")
        self._status: dict[str, _PeerStatus] = {
            p.name: _PeerStatus(p.name) for p in self.peers
        }
        self._last_tick: float | None = None
        self._merged: list[dict] = []
        self._dropped: list[str] = []
        self._index: dict[tuple, _Sample] = {}
        self._scrapes = 0
        self._conflicts = 0
        self._skew: dict[str, float] = {}
        self._versions: dict[str, dict[str, float]] = {}
        self._skew_since: dict[str, float] = {}
        self._convergence: dict[str, list[float]] = {}
        self._conv_hists: dict[str, Histogram] = {}
        self._alert_log: deque[dict] = deque(maxlen=256)
        rules = tuple(rules) if rules is not None else ()
        if rules:
            from spark_bagging_tpu_torch.telemetry.alerts import AlertEngine

            self.alerts = AlertEngine(rules, registry=self)
        else:
            self.alerts = None

    # -- sampling view (the alert engine's registry) -------------------

    def peek(self, name: str, labels: dict | None = None):
        """The merged series' current sample, or None — the same
        absent-is-not-zero contract :meth:`Registry.peek` gives the
        alert engine, over the LATEST merged snapshot."""
        with self._lock:
            return self._index.get((name, _label_key(labels)))

    # -- the tick ------------------------------------------------------

    def tick(self, now: float | None = None, *,
             force: bool = False) -> bool:
        """Scrape-and-merge if ``interval_s`` has elapsed (or
        ``force``). Returns whether a pass ran. ``now`` injects the
        clock (a virtual drill); default is the monotonic clock."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            due = (force or self._last_tick is None
                   or now - self._last_tick >= self.interval_s)
            if due:
                self._last_tick = now
        if due:
            self.scrape_all(now)
        return due

    def scrape_all(self, now: float | None = None) -> None:
        """One full pass: scrape every peer, merge the fresh ones,
        recompute fleet series + version skew, evaluate the alert
        rules — all on the injected clock."""
        now = self._clock() if now is None else float(now)
        with self._scrape_lock:
            results: dict[str, tuple[bool, Any]] = {}

            def _scrape_one(p) -> None:
                try:
                    results[p.name] = (True, p.scrape())
                # sbt-lint: disable=swallowed-fault — counted (sbt_fleet_scrape_failures_total), aged, emitted, and surfaced stale in /fleet/healthz
                except Exception as e:  # noqa: BLE001 — a peer outage
                    # is DATA here, not a fault of the aggregator
                    results[p.name] = (False, e)
                    _emit({
                        "kind": "fleet_scrape_failed",
                        "peer": p.name, "error": repr(e),
                    })

            # fault probes fire FIRST, sequentially, in peer order:
            # the chaos plan's hit indices must be a pure function of
            # (tick, peer position), never of network completion order
            pending = []
            for p in self.peers:
                try:
                    import spark_bagging_tpu_torch.faults as faults_mod

                    if faults_mod.ACTIVE is not None:
                        faults_mod.fire("fleet.scrape", peer=p.name)
                # sbt-lint: disable=swallowed-fault — counted (sbt_fleet_scrape_failures_total), aged, emitted, and surfaced stale in /fleet/healthz
                except Exception as e:  # noqa: BLE001 — an injected
                    # scrape fault IS the scripted peer outage
                    results[p.name] = (False, e)
                    _emit({
                        "kind": "fleet_scrape_failed",
                        "peer": p.name, "error": repr(e),
                    })
                    continue
                pending.append(p)
            # network peers scrape CONCURRENTLY (each urlopen can burn
            # its whole timeout — run sequentially, a half-down fleet
            # would stall a /fleet/healthz pass by timeout x dead
            # peers, tripping the external prober exactly during the
            # partial outage it exists to report); in-process peers
            # are lock-protected snapshot copies and stay inline
            remote = [p for p in pending
                      if getattr(p, "remote", False)]
            if len(remote) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                    max_workers=min(8, len(remote)),
                    thread_name_prefix="sbt-fleet-scrape",
                ) as pool:
                    futures = [pool.submit(_scrape_one, p)
                               for p in remote]
                    for p in pending:
                        if p not in remote:
                            _scrape_one(p)
                    for f in futures:
                        f.result()
            else:
                for p in pending:
                    _scrape_one(p)
            with self._lock:
                self._scrapes += len(self.peers)
                for name, (ok, payload) in results.items():
                    st = self._status[name]
                    st.last_attempt_t = now
                    st.ok = ok
                    if ok:
                        st.last_ok_t = now
                        st.error = None
                        st.snapshot = payload
                    else:
                        st.failures += 1
                        st.error = repr(payload)
                fresh = self._fresh_locked(now)
                fresh_names = {st.name for st in fresh}
                named: list[tuple[str, list[dict]]] = []
                for st in self._status.values():
                    snap = (st.snapshot or {}).get("metrics") or []
                    if not snap:
                        continue  # never scraped: nothing to merge
                    if st.name not in fresh_names:
                        # a stale peer's CUMULATIVE series (counters,
                        # histograms) stay in the merge at their
                        # last-known values — a counter is a lower
                        # bound that never lies, and dropping it would
                        # make the merged sum NON-MONOTONIC (the
                        # peer's whole history would vanish and then
                        # reappear on recovery, which a burn-rate rule
                        # reads as a massive failure spike). Its
                        # GAUGES drop out: a stale queue depth is a
                        # stale lie, and staleness itself is what the
                        # age gauge/quorum surface
                        snap = [e for e in snap if e["kind"] != "gauge"]
                    named.append((st.name, snap))
                merged, dropped = merge_snapshots(named)
                self._conflicts += len(dropped)
                self._dropped = dropped
                self._update_skew_locked(now)
                merged.extend(self._fleet_entries_locked(
                    fresh, now, merged_n=len(merged)
                ))
                merged.sort(key=_entry_sort_key)
                self._merged = merged
                self._index = {
                    (e["name"], _label_key(e["labels"])):
                        _Sample(e["kind"], e.get("value"))
                    for e in merged if e["kind"] != "histogram"
                }
            if self.alerts is not None:
                events = self.alerts.evaluate(now=now)
                if events:
                    with self._lock:
                        self._alert_log.extend(events)

    # -- locked helpers ------------------------------------------------

    def _fresh_locked(self, now: float) -> list[_PeerStatus]:
        return [
            st for st in self._status.values()
            if st.ok and st.last_ok_t is not None
            and now - st.last_ok_t <= self.stale_after_s
        ]

    def _update_skew_locked(self, now: float) -> None:
        # versions come from every peer's LAST-KNOWN snapshot, not
        # just the fresh set: a peer that wedges mid-upgrade at the
        # old version and stops answering scrapes must HOLD the skew
        # excursion open (that outage IS the stalled roll the
        # skew-stalled rule exists to page on) — computing over fresh
        # peers only would read skew 0, record a spurious short
        # convergence, and resolve the alert while the fleet is split
        versions: dict[str, dict[str, float]] = {}
        for st in self._status.values():
            for e in (st.snapshot or {}).get("metrics") or []:
                if e["name"] != "sbt_serving_model_version":
                    continue
                model = (e.get("labels") or {}).get("model", "")
                versions.setdefault(model, {})[st.name] = float(
                    e["value"]
                )
        skew: dict[str, float] = {}
        for model, per_peer in versions.items():
            vals = list(per_peer.values())
            skew[model] = max(vals) - min(vals)
        # convergence excursions: skew leaving 0 starts the clock for
        # that model, returning to 0 observes the duration (a model
        # that disappears mid-excursion — all reporting peers lost —
        # keeps its start; the excursion is still open)
        for model, s in skew.items():
            if s > 0 and model not in self._skew_since:
                # sbt-lint: disable=shared-state-unlocked — every caller holds self._lock (the _locked naming convention)
                self._skew_since[model] = now
            elif s == 0 and model in self._skew_since:
                dt = now - self._skew_since.pop(model)
                self._convergence.setdefault(model, []).append(dt)
                self._conv_hists.setdefault(
                    model, Histogram()
                ).observe(dt)
        # sbt-lint: disable=shared-state-unlocked — every caller holds self._lock (the _locked naming convention)
        self._skew = skew
        # sbt-lint: disable=shared-state-unlocked — every caller holds self._lock (the _locked naming convention)
        self._versions = versions

    def _fleet_entries_locked(self, fresh: list[_PeerStatus],
                              now: float, *,
                              merged_n: int) -> list[dict]:
        n = len(self.peers)
        n_fresh = len(fresh)
        healthy = sum(
            1 for st in fresh
            if bool(((st.snapshot or {}).get("health") or
                     {"healthy": True}).get("healthy", True))
        )
        out = [
            _value_entry("sbt_fleet_peers", "gauge", {}, float(n)),
            _value_entry("sbt_fleet_peers_fresh", "gauge", {},
                         float(n_fresh)),
            _value_entry("sbt_fleet_peers_stale", "gauge", {},
                         float(n - n_fresh)),
            _value_entry("sbt_fleet_quorum", "gauge", {},
                         1.0 if healthy >= self.quorum else 0.0),
            _value_entry("sbt_fleet_scrapes_total", "counter", {},
                         float(self._scrapes)),
            _value_entry("sbt_fleet_merged_series", "gauge", {},
                         float(merged_n)),
            _value_entry("sbt_fleet_merge_conflicts_total", "counter",
                         {}, float(self._conflicts)),
        ]
        for st in self._status.values():
            out.append(_value_entry(
                "sbt_fleet_scrape_failures_total", "counter",
                {"process": st.name}, float(st.failures),
            ))
            if st.last_ok_t is not None:
                # never-scraped peers get NO age series (absent, not
                # zero — and not +Inf, which JSON cannot carry and a
                # strict /fleet/varz consumer would choke on); their
                # outage is visible as fresh=False + the failure count
                out.append(_value_entry(
                    "sbt_fleet_scrape_age_seconds", "gauge",
                    {"process": st.name}, now - st.last_ok_t,
                ))
        # per-peer versions are last-known (stale peers included, like
        # the skew they feed): a version only moves forward, and the
        # wedged peer's OLD version is exactly the datum an operator
        # diagnosing a stalled roll needs to see
        for model, per_peer in self._versions.items():
            for pname, v in sorted(per_peer.items()):
                out.append(_value_entry(
                    "sbt_fleet_version", "gauge",
                    {"model": model, "process": pname}, v,
                ))
        for model, s in self._skew.items():
            out.append(_value_entry(
                "sbt_fleet_version_skew", "gauge", {"model": model}, s,
            ))
        # the unlabeled twin: max skew over models — what the generic
        # skew-stalled rule watches without knowing model names
        out.append(_value_entry(
            "sbt_fleet_version_skew", "gauge", {},
            max(self._skew.values()) if self._skew else 0.0,
        ))
        for model, h in self._conv_hists.items():
            out.append(histogram_entry(
                "sbt_fleet_convergence_seconds", {"model": model}, h,
            ))
        return out

    # -- views ---------------------------------------------------------

    def merged_snapshot(self) -> list[dict]:
        """The latest merged fleet snapshot (entry dicts, sorted) —
        what ``/fleet/metrics`` renders."""
        with self._lock:
            return [dict(e) for e in self._merged]

    def version_skew(self) -> dict[str, float]:
        with self._lock:
            return dict(self._skew)

    def convergence_observations(self) -> dict[str, list[float]]:
        """Per-model skew-excursion durations observed so far (the raw
        observations behind ``sbt_fleet_convergence_seconds``)."""
        with self._lock:
            return {m: list(v) for m, v in self._convergence.items()}

    def fleet_health(self, now: float | None = None) -> dict[str, Any]:
        """Quorum health over peer healthz + scrape staleness:
        ``healthy`` while at least ``quorum`` peers are fresh AND
        report healthy (``degraded`` whenever any peer is lost or
        unhealthy) — the serving plane's serve-what-survives semantics
        at fleet scope."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            fresh = {st.name for st in self._fresh_locked(now)}
            peers: dict[str, dict] = {}
            healthy_n = 0
            for st in self._status.values():
                is_fresh = st.name in fresh
                peer_health = ((st.snapshot or {}).get("health")
                               or {"healthy": True})
                ok = is_fresh and bool(peer_health.get("healthy", True))
                healthy_n += 1 if ok else 0
                peers[st.name] = {
                    "fresh": is_fresh,
                    "healthy": ok,
                    "failures": st.failures,
                    "age_s": (now - st.last_ok_t
                              if st.last_ok_t is not None else None),
                    "error": st.error,
                }
            quorum_met = healthy_n >= self.quorum
            return {
                "healthy": quorum_met,
                "degraded": healthy_n < len(self.peers),
                "fresh": len(fresh),
                "healthy_peers": healthy_n,
                "required": self.quorum,
                "configured": len(self.peers),
                "peers": peers,
            }

    def fleet_varz(self, now: float | None = None) -> dict[str, Any]:
        """The ``/fleet/varz`` JSON: peer status, quorum health, skew,
        and the merged snapshot with per-histogram quantiles computed
        from the MERGED bucket counts (exact — never an average of
        peer percentiles)."""
        now_c = self._clock() if now is None else float(now)
        with self._lock:
            merged = [dict(e) for e in self._merged]
            dropped = list(self._dropped)
            skew = dict(self._skew)
            convergence = {m: list(v)
                           for m, v in self._convergence.items()}
        for e in merged:
            if e["kind"] == "histogram":
                e["quantiles"] = snapshot_quantiles(e)
        out: dict[str, Any] = {
            "ts": time.time(),
            "interval_s": self.interval_s,
            "stale_after_s": self.stale_after_s,
            "health": self.fleet_health(now_c),
            "version_skew": skew,
            "convergence_seconds": convergence,
            "merge_dropped": dropped,
            "metrics": merged,
        }
        if self.alerts is not None:
            out["alerts"] = self.alerts.state()
        return out

    def incident_timeline(self, *, window_s: float | None = None,
                          clock_key: str = "ts") -> dict[str, Any]:
        """The ``/fleet/incidents`` JSON: every peer's flight feed
        (from its last successful scrape — a stale peer's last-known
        dumps still matter, they are often the incident) plus the
        aggregator's own alert firings, correlated into incidents."""
        with self._lock:
            feeds: list[tuple[str, dict | None]] = [
                (st.name, (st.snapshot or {}).get("flight"))
                for st in self._status.values()
            ]
            feeds.append(("fleet", {"dumps": [],
                                    "events": list(self._alert_log)}))
        w = (self.correlation_window_s if window_s is None
             else float(window_s))
        incidents, events = correlate_incidents(
            feeds, window_s=w, clock_key=clock_key,
        )
        return {
            "window_s": w,
            "clock": clock_key,
            "n_incidents": len(incidents),
            "incidents": incidents,
            "events": events,
            "digest": timeline_digest(incidents),
        }


# -- the default alert pack ----------------------------------------------

def default_fleet_rules(
    *,
    skew_fast_s: float = 60.0,
    skew_slow_s: float = 600.0,
    peer_fast_s: float = 30.0,
    peer_slow_s: float = 120.0,
    burn_threshold_per_s: float = 0.02,
    burn_fast_s: float = 60.0,
    burn_slow_s: float = 600.0,
    cooldown_s: float = 300.0,
    name_prefix: str = "fleet-",
) -> list:
    """The fleet plane's starter rules, evaluated over MERGED series:

    - ``skew-stalled``: version skew stayed above 0 across both
      windows — a rolling swap started and never converged (a healthy
      roll's excursion is shorter than ``skew_fast_s``);
    - ``peer-lost``: at least one peer stale across both windows (a
      single scrape blip inside the fast window never pages);
    - ``burn-rate``: the fleet-wide request-failure counter's
      per-second rate breached in both windows (multi-window burn
      rate over the SUMMED counter — one peer failing everything and
      five peers each failing a sixth look identical here, which is
      the point).
    """
    from spark_bagging_tpu_torch.telemetry.alerts import AlertRule

    return [
        AlertRule(
            f"{name_prefix}skew-stalled", "sbt_fleet_version_skew",
            threshold=0.0, kind="value", op=">",
            fast_window_s=skew_fast_s, slow_window_s=skew_slow_s,
            cooldown_s=cooldown_s,
            description="model version skew across the fleet never "
                        "returned to 0 — a rolling swap is stalled",
        ),
        AlertRule(
            f"{name_prefix}peer-lost", "sbt_fleet_peers_stale",
            threshold=0.0, kind="value", op=">",
            fast_window_s=peer_fast_s, slow_window_s=peer_slow_s,
            cooldown_s=cooldown_s,
            description="one or more peers stopped answering scrapes "
                        "(stale: excluded from merge and quorum)",
        ),
        AlertRule(
            f"{name_prefix}burn-rate",
            "sbt_serving_request_failures_total",
            threshold=burn_threshold_per_s, kind="rate", op=">",
            fast_window_s=burn_fast_s, slow_window_s=burn_slow_s,
            cooldown_s=cooldown_s,
            description="fleet-wide request failure rate is burning "
                        "error budget in both windows",
        ),
    ]


# -- process default -----------------------------------------------------

_default: FleetAggregator | None = None
_default_lock = make_lock("telemetry.fleet.default")


def install(aggregator: FleetAggregator) -> FleetAggregator:
    """Install the process-default aggregator — what the ``/fleet/*``
    scrape routes serve and tick. Replaces any prior default."""
    global _default
    with _default_lock:
        _default = aggregator
    return aggregator


def get() -> FleetAggregator | None:
    return _default


def uninstall() -> None:
    global _default
    with _default_lock:
        _default = None
