"""The fleet plane in the port, held against the JAX package's:

- ``Histogram.merge``: the same seeded observation streams merged in
  either package give the same bucket counts and the same p50/p95/p99
  — and those of one histogram that saw the union;
- ``merge_snapshots``: the same per-process snapshots (counters,
  labeled gauges, histograms, a kind conflict) merge to the same
  series and the same dropped names in either package, whichever
  package's registry produced them, with the same ``merged_digest``;
- ``FleetAggregator``: the same scripted scrape sequence (a peer that
  goes stale and recovers, version skew rising and converging) gives
  the same merged snapshot, health and convergence transcript;

and the JAX package's contracts, copied: a stale peer's counters
freeze (never zeros) while its gauges drop out, quorum degrades then
is lost, an ``HTTPPeer`` scrapes a live ``/varz`` (a dead URL is a
counted failure), the ``/fleet/*`` routes serve the merge, and the
``peer-loss`` builtin plan fires the ``fleet.scrape`` site
deterministically.
"""

import json
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from spark_bagging_tpu import telemetry as jtelemetry  # noqa: E402
from spark_bagging_tpu.telemetry import fleet as jfleet  # noqa: E402
from spark_bagging_tpu.telemetry.registry import Histogram as JHistogram  # noqa: E402
from spark_bagging_tpu.telemetry.registry import Registry as JRegistry  # noqa: E402
from spark_bagging_tpu_torch import faults, telemetry  # noqa: E402
from spark_bagging_tpu_torch.telemetry import fleet  # noqa: E402
from spark_bagging_tpu_torch.telemetry import server as tserver  # noqa: E402
from spark_bagging_tpu_torch.telemetry.registry import (  # noqa: E402
    Histogram,
    Registry,
)


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()
    fleet.uninstall()
    tserver.clear_health_sources()
    yield
    tserver.stop_server()
    telemetry.recorder.disarm()
    fleet.uninstall()
    tserver.clear_health_sources()
    for t in (telemetry, jtelemetry):
        t.reset()
        t.enable()


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- parity with the JAX package ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_merge_quantiles_equal_jax_and_the_union(seed):
    rng = np.random.default_rng(seed)
    a_obs = rng.lognormal(-3.0, 1.0, 700).tolist()
    b_obs = rng.lognormal(0.5, 2.0, 300).tolist()
    out = []
    for H in (Histogram, JHistogram):
        a, b, union = H(), H(), H()
        for v in a_obs:
            a.observe(v)
            union.observe(v)
        for v in b_obs:
            b.observe(v)
            union.observe(v)
        a.merge(b)
        assert a.counts == union.counts and a.count == 1000
        out.append((a.counts, [a.quantile(q) for q in (0.5, 0.95, 0.99)],
                    [union.quantile(q) for q in (0.5, 0.95, 0.99)]))
    assert out[0] == out[1]
    assert out[0][1] == out[0][2]


def _registries(reg_cls, seed: int):
    rng = np.random.default_rng(seed)
    regs = []
    for p in range(3):
        r = reg_cls()
        r.inc("sbt_serving_requests_total", float(rng.integers(1, 100)))
        r.inc("sbt_capacity_demand_rows_total", float(rng.integers(1, 9)),
              labels={"model": "m"})
        r.set("sbt_serving_queue_depth", float(rng.integers(0, 16)))
        r.set("sbt_serving_model_version", float(1 + (p == 2)),
              labels={"model": "m"})
        for v in rng.lognormal(-4, 1.5, 50 * (p + 1)):
            r.observe("sbt_serving_latency_seconds", float(v))
        if p == 1:
            r.set("sbt_x_total", 5.0)  # a kind conflict
        else:
            r.inc("sbt_x_total", 1.0)
        regs.append(r)
    return regs


def _strip(snap):
    """A merged snapshot without its exemplars' wall-clock stamps."""
    return json.loads(json.dumps([
        {k: v for k, v in e.items() if k not in ("exemplars",
                                                 "slow_exemplars")}
        for e in snap]))


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_snapshots_equal_jax(seed):
    ours = [(f"p{i}", r.snapshot())
            for i, r in enumerate(_registries(Registry, seed))]
    theirs = [(f"p{i}", r.snapshot())
              for i, r in enumerate(_registries(JRegistry, seed))]
    m_o, d_o = fleet.merge_snapshots(ours)
    m_j, d_j = jfleet.merge_snapshots(theirs)
    assert d_o == d_j == ["sbt_x_total"]
    assert _strip(m_o) == _strip(m_j)
    assert fleet.merged_digest(m_o) == jfleet.merged_digest(m_j)
    # either package merges the other's snapshots the same way
    assert _strip(fleet.merge_snapshots(theirs)[0]) == _strip(m_o)
    merged = {(e["name"], tuple(sorted(e["labels"].items()))): e
              for e in m_o}
    total = sum(e["value"] for _p, s in ours for e in s
                if e["name"] == "sbt_serving_requests_total")
    assert merged[("sbt_serving_requests_total", ())]["value"] == total


class _FlakyPeer:
    """Scripted peer: fails while ``down`` is set."""

    def __init__(self, name, registry):
        self.name = name
        self._reg = registry
        self.down = False

    def scrape(self):
        if self.down:
            raise RuntimeError("scripted outage")
        return {"metrics": self._reg.snapshot()}


def _drill(fmod, reg_cls):
    regs = [reg_cls() for _ in range(3)]
    peers = [_FlakyPeer(f"p{i}", r) for i, r in enumerate(regs)]
    agg = fmod.FleetAggregator(peers, interval_s=0.0, clock=lambda: 0.0)
    transcript = []
    for t in range(8):
        for i, r in enumerate(regs):
            r.inc("sbt_serving_requests_total", float(i + 1))
            version = 2.0 if (i == 0 and t >= 2) or t >= 5 else 1.0
            r.set("sbt_serving_model_version", version,
                  labels={"model": "m"})
            r.observe("sbt_serving_latency_seconds", 0.001 * (t + i + 1))
        peers[2].down = 3 <= t <= 4
        agg.scrape_all(now=float(t))
        h = agg.fleet_health(now=float(t))
        transcript.append((h["healthy"], h["degraded"],
                           agg.peek("sbt_fleet_version_skew",
                                    {"model": "m"}).value,
                           agg.peek("sbt_serving_requests_total").value))
    return (_strip(agg.merged_snapshot()), transcript,
            agg.convergence_observations())


def test_aggregator_drill_equals_jax():
    ours = _drill(fleet, Registry)
    theirs = _drill(jfleet, JRegistry)
    assert ours == theirs
    _, transcript, convergence = ours
    assert [t[2] for t in transcript] == [0, 0, 1, 1, 1, 0, 0, 0]
    assert transcript[3][:2] == (True, True)  # a stale peer: degraded
    assert convergence == {"m": [3.0]}


# -- the JAX package's contracts ------------------------------------------

def test_stale_peer_freezes_counters_drops_gauges_never_zeros():
    r1, r2 = Registry(), Registry()
    r1.inc("sbt_serving_requests_total", 10)
    r2.inc("sbt_serving_requests_total", 32)
    r2.set("sbt_serving_queue_depth", 7.0)
    flaky = _FlakyPeer("p1", r2)
    agg = fleet.FleetAggregator([fleet.RegistryPeer("p0", r1), flaky],
                                interval_s=0.0, clock=lambda: 0.0)
    agg.scrape_all(now=1.0)
    assert agg.peek("sbt_serving_requests_total").value == 42
    flaky.down = True
    r2.inc("sbt_serving_requests_total", 100)
    agg.scrape_all(now=2.0)
    assert agg.peek("sbt_serving_requests_total").value == 42
    assert agg.peek("sbt_serving_queue_depth", {"process": "p1"}) is None
    assert agg.peek("sbt_fleet_peers_stale").value == 1
    assert agg.peek("sbt_fleet_scrape_failures_total",
                    {"process": "p1"}).value == 1
    flaky.down = False
    agg.scrape_all(now=3.0)
    assert agg.peek("sbt_serving_requests_total").value == 142
    assert agg.peek("sbt_fleet_peers_stale").value == 0


def test_quorum_health_degrades_then_loses():
    regs = [Registry() for _ in range(3)]
    flakies = [_FlakyPeer(f"p{i}", r) for i, r in enumerate(regs)]
    agg = fleet.FleetAggregator(flakies, interval_s=0.0, clock=lambda: 0.0)
    agg.scrape_all(now=1.0)
    h = agg.fleet_health(now=1.0)
    assert h["healthy"] and not h["degraded"]
    flakies[2].down = True
    agg.scrape_all(now=2.0)
    h = agg.fleet_health(now=2.0)
    assert h["healthy"] and h["degraded"]
    flakies[1].down = True
    agg.scrape_all(now=3.0)
    assert not agg.fleet_health(now=3.0)["healthy"]
    assert agg.peek("sbt_fleet_quorum").value == 0.0


def test_http_peer_scrapes_a_live_varz_and_fleet_routes():
    telemetry.registry().inc("sbt_serving_requests_total", 6)
    port = tserver.start_server(0)
    other = Registry()
    other.inc("sbt_serving_requests_total", 10)
    agg = fleet.FleetAggregator([
        fleet.HTTPPeer("self", f"http://127.0.0.1:{port}"),
        fleet.RegistryPeer("mem", other),
        fleet.HTTPPeer("ghost", "http://127.0.0.1:1", timeout_s=0.2),
    ], interval_s=0.0)
    agg.scrape_all()
    assert agg.peek("sbt_serving_requests_total").value == 16
    assert agg.peek("sbt_fleet_scrape_failures_total",
                    {"process": "ghost"}).value == 1
    h = agg.fleet_health()
    assert h["healthy"] and h["degraded"]
    assert _get(port, "/fleet/varz")[0] == 404
    fleet.install(agg)
    code, body = _get(port, "/fleet/metrics")
    assert code == 200 and "sbt_serving_requests_total" in body
    code, body = _get(port, "/fleet/healthz")
    assert code == 200 and json.loads(body)["degraded"] is True
    code, body = _get(port, "/fleet/incidents")
    assert code == 200 and "incidents" in json.loads(body)


def test_peer_loss_plan_fires_the_scrape_site_deterministically():
    regs = [Registry() for _ in range(3)]
    agg = fleet.FleetAggregator(
        [fleet.RegistryPeer(f"p{i}", r) for i, r in enumerate(regs)],
        interval_s=0.0, clock=lambda: 0.0)
    plan = faults.builtin_plan("peer-loss")
    with faults.armed(plan):
        for t in range(25):
            agg.scrape_all(now=float(t))
    assert agg.peek("sbt_fleet_scrape_failures_total",
                    {"process": "p2"}).value == 20
    assert agg.peek("sbt_fleet_scrape_failures_total",
                    {"process": "p0"}).value == 0
    assert agg.peek("sbt_fleet_peers_stale").value == 0
    snap = plan.snapshot()
    assert snap["hits"]["fleet.scrape"] == 75
    assert snap["fires"]["fleet.scrape"] == 20
