"""SLO specs and the serving regression gate.

A serving run (a replayed workload, or a load phase of the card's
smoke test) produces a metric report — latency percentiles,
throughput, padding waste, overload sheds, post-warmup build count (on
the card a build is one CUDA-graph capture). This module turns that
report into a CI verdict two ways:

- **absolute**: an :class:`SLOSpec` names hard ceilings/floors
  (p50/p95/p99 latency, rps floor, padding-waste ceiling, overload
  budget, zero post-warmup recompiles) and :func:`evaluate` checks the
  report against it;
- **relative**: :func:`compare_to_baseline` diffs the report against a
  previously saved one with tolerance bands (throughput may not drop
  more than ``rps_tolerance``, latency percentiles may not grow more
  than ``latency_tolerance``) — the "did this change slow the hot
  path" gate, robust to host noise because the bands are wide and the
  failure they hunt (a 2x forward regression) is not.

Both return an :class:`SLOResult` whose ``checks`` list one verdict
per criterion; :func:`exit_code` maps it onto the gate's exit-code
contract.

The port's copy of the JAX package's ``telemetry/slo.py`` (pure: the
same report gives the same checks in either package).

Latency-percentile semantics: serving reports carry EXACT percentiles
(computed from the full per-request latency list the tracing plane
collected), not histogram interpolations — the gate compares real
order statistics.
"""

from __future__ import annotations

import json
from typing import Any

#: Tolerance bands for baseline comparison. Wide by design: CI hosts
#: are noisy and the regressions worth gating on (a 2x forward
#: slowdown) blow far past these.
DEFAULT_RPS_TOLERANCE = 0.35
DEFAULT_LATENCY_TOLERANCE = 0.75

#: The gate exit-code contract (the JAX package's serving gates share
#: it): 0 = every check green; 2 = a host-independent invariant broke
#: (digest mismatch, compile count, overload/shed budget, drift/
#: chaos/fleet transcript); 3 = ONLY host-conditional performance
#: bands failed (rps, latency percentiles, wall-clock stage shares) —
#: real on a sized host, expected noise on a loaded shared one, so CI
#: can treat 3 as a warning band without losing the hard gate.
EXIT_OK = 0
EXIT_BREACH = 2
EXIT_HOST_BAND = 3

#: check-name classification for the contract above: these prefixes
#: (matched against ``SLOResult.checks[*]["name"]``) are wall-clock
#: measurements a loaded host legitimately moves
HOST_BAND_CHECK_PREFIXES = ("rps", "latency_", "stage_share_")


def is_host_band_check(name: str) -> bool:
    """True when a failed check of this name is a host-conditional
    performance band (exit 3) rather than a hard breach (exit 2)."""
    return name.startswith(HOST_BAND_CHECK_PREFIXES)


def exit_code(result: "SLOResult") -> int:
    """Map a gate verdict to the shared exit-code contract.

    A failed band-named check whose measured value is MISSING
    (``actual is None`` — a broken/incomplete report, see ``_check``)
    is a hard breach, never host noise: the band exit exists for real
    measurements a loaded host legitimately moves, not for gates that
    measured nothing."""
    if result.ok:
        return EXIT_OK
    if all(is_host_band_check(c["name"]) and c.get("actual") is not None
           for c in result.failures):
        return EXIT_HOST_BAND
    return EXIT_BREACH


class SLOSpec:
    """Hard serving-SLO bounds. ``None`` disables a criterion.

    ``max_padding_waste`` bounds wasted work as a fraction: padding
    rows over total padded rows — or, when the report carries
    per-bucket cost attribution (``sbt_serving_bucket_cost_*``), padding
    FLOPs over total FLOPs, the honest denominator.
    ``max_post_warmup_compiles`` defaults to 0 — the serving
    subsystem's founding contract.

    ``max_stage_share`` bounds per-stage attribution shares from the
    report's ``attribution`` section (``telemetry/perf.py``): a dict
    like ``{"queue": 0.5}`` fails the gate when queue wait exceeds
    half the measured request wall-clock — "slow because waiting" is
    a different regression than "slow because computing", and this is
    where a spec says which one it refuses to ship.
    """

    FIELDS = (
        "p50_ms", "p95_ms", "p99_ms", "min_rps", "max_padding_waste",
        "max_overloads", "max_post_warmup_compiles", "max_stage_share",
    )

    #: valid keys for ``max_stage_share`` (the perf plane's exact
    #: wall-clock decomposition)
    STAGES = ("queue", "forward", "scatter")

    def __init__(
        self,
        *,
        p50_ms: float | None = None,
        p95_ms: float | None = None,
        p99_ms: float | None = None,
        min_rps: float | None = None,
        max_padding_waste: float | None = None,
        max_overloads: int | None = None,
        max_post_warmup_compiles: int | None = 0,
        max_stage_share: dict[str, float] | None = None,
    ) -> None:
        self.p50_ms = p50_ms
        self.p95_ms = p95_ms
        self.p99_ms = p99_ms
        self.min_rps = min_rps
        self.max_padding_waste = max_padding_waste
        self.max_overloads = max_overloads
        self.max_post_warmup_compiles = max_post_warmup_compiles
        if max_stage_share is not None:
            unknown = set(max_stage_share) - set(self.STAGES)
            if unknown:
                raise ValueError(
                    f"unknown stages in max_stage_share: "
                    f"{sorted(unknown)}; have {list(self.STAGES)}"
                )
            for stage, limit in max_stage_share.items():
                if not 0.0 <= float(limit) <= 1.0:
                    raise ValueError(
                        f"max_stage_share[{stage!r}] must be in "
                        f"[0, 1], got {limit}"
                    )
        self.max_stage_share = max_stage_share

    def to_dict(self) -> dict[str, Any]:
        return {f: getattr(self, f) for f in self.FIELDS}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SLOSpec":
        unknown = set(d) - set(cls.FIELDS)
        if unknown:
            raise ValueError(
                f"unknown SLO spec fields {sorted(unknown)}; "
                f"have {list(cls.FIELDS)}"
            )
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "SLOSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def __repr__(self) -> str:
        set_fields = {k: v for k, v in self.to_dict().items()
                      if v is not None}
        return f"SLOSpec({set_fields})"


class SLOResult:
    """Verdict of one evaluation: per-criterion checks + overall ok."""

    def __init__(self, checks: list[dict[str, Any]],
                 kind: str = "absolute") -> None:
        self.checks = checks
        self.kind = kind

    @property
    def ok(self) -> bool:
        return all(c["ok"] for c in self.checks)

    @property
    def failures(self) -> list[dict[str, Any]]:
        return [c for c in self.checks if not c["ok"]]

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "ok": self.ok, "checks": self.checks}

    def render(self) -> str:
        """Human one-line-per-check summary for the CLI."""
        lines = []
        for c in self.checks:
            mark = "PASS" if c["ok"] else "FAIL"
            lines.append(
                f"  [{mark}] {c['name']}: {c['actual']} "
                f"(limit {c['op']} {c['limit']})"
            )
        verdict = "OK" if self.ok else "SLO VIOLATION"
        return f"{verdict} ({self.kind})\n" + "\n".join(lines)


def _check(name: str, actual, limit, op: str) -> dict[str, Any]:
    if actual is None:
        # a spec bound with no measured value is a broken report, not
        # a pass — gate pipelines must fail loudly on missing data
        return {"name": name, "actual": None, "limit": limit,
                "op": op, "ok": False,
                "note": "report carries no value for this criterion"}
    ok = actual <= limit if op == "<=" else actual >= limit
    return {"name": name, "actual": actual, "limit": limit, "op": op,
            "ok": bool(ok)}


def evaluate(spec: SLOSpec, report: dict[str, Any]) -> SLOResult:
    """Check a serving report against hard SLO bounds.

    ``report`` is a dict of the JAX package's replay-report keys
    (``latency_ms`` percentiles, ``rps``, ``padding`` fractions,
    ``overloads``, ``post_warmup_compiles``).
    """
    lat = report.get("latency_ms") or {}
    pad = report.get("padding") or {}
    checks: list[dict[str, Any]] = []
    for q in ("p50", "p95", "p99"):
        limit = getattr(spec, f"{q}_ms")
        if limit is not None:
            checks.append(_check(f"latency_{q}_ms", lat.get(q), limit, "<="))
    if spec.min_rps is not None:
        checks.append(_check("rps", report.get("rps"), spec.min_rps, ">="))
    if spec.max_padding_waste is not None:
        # prefer the FLOPs-weighted fraction when cost attribution ran
        waste = pad.get("waste_flops_frac")
        name = "padding_waste_flops_frac"
        if waste is None:
            waste = pad.get("waste_rows_frac")
            name = "padding_waste_rows_frac"
        checks.append(_check(name, waste, spec.max_padding_waste, "<="))
    if spec.max_overloads is not None:
        checks.append(_check("overloads", report.get("overloads"),
                             spec.max_overloads, "<="))
    if spec.max_post_warmup_compiles is not None:
        checks.append(_check(
            "post_warmup_compiles", report.get("post_warmup_compiles"),
            spec.max_post_warmup_compiles, "<=",
        ))
    if spec.max_stage_share:
        stages = (report.get("attribution") or {}).get("stages") or {}
        for stage in sorted(spec.max_stage_share):
            share = (stages.get(stage) or {}).get("share")
            checks.append(_check(
                f"stage_share_{stage}", share,
                spec.max_stage_share[stage], "<=",
            ))
    return SLOResult(checks, kind="absolute")


def compare_to_baseline(
    report: dict[str, Any],
    baseline: dict[str, Any],
    *,
    rps_tolerance: float = DEFAULT_RPS_TOLERANCE,
    latency_tolerance: float = DEFAULT_LATENCY_TOLERANCE,
) -> SLOResult:
    """Relative regression gate: the report may not be materially worse
    than the baseline report.

    Throughput floor: ``rps >= baseline_rps * (1 - rps_tolerance)``.
    Latency ceilings: each percentile ``<= baseline * (1 +
    latency_tolerance * tail factor)`` where the tail factor widens
    with the percentile (1x / 2x / 3x for p50 / p95 / p99): on a
    shared CI host the far tail of sub-millisecond batches is
    scheduler noise, while a real hot-path regression moves the median
    and throughput decisively — the gate leans on the stable signals
    and keeps the tails as wide tripwires. Determinism invariants are
    compared exactly: post-warmup compiles may not exceed the
    baseline's, and when both reports carry an ``output_digest`` over
    the same workload digest, they must match bitwise.
    """
    checks: list[dict[str, Any]] = []
    base_rps = baseline.get("rps")
    if base_rps:
        checks.append(_check(
            "rps_vs_baseline", report.get("rps"),
            round(base_rps * (1.0 - rps_tolerance), 3), ">=",
        ))
    base_lat = baseline.get("latency_ms") or {}
    lat = report.get("latency_ms") or {}
    for q, tail_factor in (("p50", 1.0), ("p95", 2.0), ("p99", 3.0)):
        b = base_lat.get(q)
        if b is not None:
            checks.append(_check(
                f"latency_{q}_vs_baseline", lat.get(q),
                round(b * (1.0 + latency_tolerance * tail_factor), 4),
                "<=",
            ))
    base_compiles = baseline.get("post_warmup_compiles")
    if base_compiles is not None:
        # suffixed like every other relative check: a combined
        # absolute+baseline gate would otherwise render two
        # identically-named compile checks with different limits
        checks.append(_check(
            "post_warmup_compiles_vs_baseline",
            report.get("post_warmup_compiles"), base_compiles, "<=",
        ))
    # bitwise determinism: same workload + same seed must reproduce the
    # baseline's outputs exactly — only comparable when both reports
    # ran the identical EXPERIMENT: same schedule (workload digest),
    # same payload seed (output bytes derive from it), same batcher
    # knobs (composition derives from them), and both in virtual mode
    # (timed mode is documented non-deterministic: its batch
    # composition follows a real worker clock, so differing output
    # bytes there are expected, not a breach)
    if (
        report.get("mode", "virtual") == "virtual"
        and baseline.get("mode", "virtual") == "virtual"
        and report.get("workload_digest") is not None
        and report.get("workload_digest") == baseline.get("workload_digest")
        and report.get("seed") == baseline.get("seed")
        and report.get("batcher") == baseline.get("batcher")
        and baseline.get("output_digest") is not None
    ):
        same = report.get("output_digest") == baseline["output_digest"]
        checks.append({
            "name": "output_digest_vs_baseline",
            "actual": report.get("output_digest"),
            "limit": baseline["output_digest"],
            "op": "==", "ok": bool(same),
        })
    return SLOResult(checks, kind="baseline")
