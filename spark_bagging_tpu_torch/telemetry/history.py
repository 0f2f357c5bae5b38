"""Longitudinal verification history — the trend store.

Every verification run that produces a deterministic identity — a
scenario-conformance pass, a serving bench, a full tier-1 session, a
load phase of the card's smoke test — appends ONE compact record to
``telemetry_dir()/history/history.jsonl``: run id, the digests that
prove determinism, SLO outcomes, and the headline numbers worth
trending. The file is append-only JSONL so concurrent writers
interleave whole lines and a torn tail line degrades to a skipped
record, never a broken store.

:func:`compare_trend` is the read half: it groups records by
``(kind, key)`` and separates the two failure classes regression
tracking must never conflate —

- **digest flips** (a deterministic identity changed between runs):
  exact, no tolerance, always a finding. Same for an SLO verdict going
  ``ok -> failed``.
- **numeric drift** (wall-clock, rps): judged against a CI-noise band
  (default ``NOISE_TOLERANCE``, the SLO gate's rps band) around the
  median of the PRIOR runs in the group — run-to-run wobble inside the
  band is reported as stable, movement beyond it as drift. Advisory:
  drift warns, only flips fail (``ok`` is "no flips").

Surfaced by the exposition server's ``/debug/history`` route. History
lives under the telemetry dir on purpose: run artifacts, not source.

The port's copy of the JAX package's ``telemetry/history.py``, in its
file format: either package reads the other's ``history.jsonl``.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Any

from spark_bagging_tpu_torch.telemetry.sinks import telemetry_dir

HISTORY_SCHEMA_VERSION = 1

#: the CI-noise band for numeric trend fields — deliberately the same
#: width as the SLO gate's rps tolerance (telemetry/slo.py): both
#: hunt decisive movement, not scheduler wobble on a shared host
NOISE_TOLERANCE = 0.35

#: record kinds the store knows about (anything else is accepted —
#: the schema is open — but these are what the repo's writers append)
KNOWN_KINDS = ("scenario", "bench", "tier")


def history_dir() -> str:
    """``telemetry_dir()/history`` — created on first use, a run
    artifact like every other file under the telemetry dir."""
    path = os.path.join(telemetry_dir(), "history")
    os.makedirs(path, exist_ok=True)
    return path


def history_path() -> str:
    return os.path.join(history_dir(), "history.jsonl")


def append_record(
    kind: str,
    key: str,
    *,
    digests: dict[str, str] | None = None,
    numbers: dict[str, float] | None = None,
    slo_ok: bool | None = None,
    detail: dict[str, Any] | None = None,
    run_id: str | None = None,
    ts: float | None = None,
    path: str | None = None,
) -> dict[str, Any]:
    """Append one compact record; returns what was written.

    ``digests`` are the exact-identity fields :func:`compare_trend`
    treats as flips when they change; ``numbers`` are trended against
    the noise band; ``detail`` rides along unjudged (per-module tier
    seconds, bench sub-reports). ``ts``/``run_id`` are injectable so
    writers on a virtual clock stay deterministic.
    """
    from spark_bagging_tpu_torch import telemetry

    ts = time.time() if ts is None else float(ts)
    record = {
        "schema": HISTORY_SCHEMA_VERSION,
        "ts": ts,
        "run_id": run_id or f"{kind}-{key}-{int(ts * 1e3)}-{os.getpid()}",
        "kind": kind,
        "key": key,
    }
    if digests:
        record["digests"] = dict(digests)
    if numbers:
        record["numbers"] = {k: float(v) for k, v in numbers.items()}
    if slo_ok is not None:
        record["slo_ok"] = bool(slo_ok)
    if detail:
        record["detail"] = detail
    out = path or history_path()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "a+b") as f:
        # a writer killed mid-append leaves a torn tail with no
        # newline; gluing the next record onto it would corrupt BOTH.
        # One seek+read per append keeps every later record intact
        # (the torn fragment itself degrades to one skipped line).
        f.seek(0, os.SEEK_END)
        if f.tell() > 0:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")
        f.write(json.dumps(record, sort_keys=True).encode() + b"\n")
    telemetry.inc("sbt_history_appends_total")
    return record


def read_history(path: str | None = None,
                 limit: int | None = None) -> list[dict[str, Any]]:
    """Read the store in append order. A torn or garbage line (a
    writer killed mid-append) is skipped, never fatal — the store is
    observability, and one lost record beats a broken trend page.
    ``limit`` keeps the NEWEST records."""
    src = path or history_path()
    records: list[dict[str, Any]] = []
    if not os.path.exists(src):
        return records
    with open(src) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    if limit is not None and limit >= 0:
        # limit=0 means NONE: records[-0:] would slice from the start
        # and return everything (the /debug/spans lesson)
        records = records[-limit:] if limit > 0 else []
    return records


def _group_key(rec: dict[str, Any]) -> str:
    return f"{rec.get('kind', '?')}:{rec.get('key', '?')}"


def compare_trend(
    records: list[dict[str, Any]],
    *,
    tolerance: float = NOISE_TOLERANCE,
) -> dict[str, Any]:
    """The longitudinal verdict over a record list (typically
    :func:`read_history`'s output).

    Per ``(kind, key)`` group, in record order:

    - every ``digests`` entry that CHANGES between consecutive runs is
      a **flip** (exact comparison — determinism has no noise band);
      an ``slo_ok`` transition ``true -> false`` is flagged the same
      way (class ``slo``);
    - the newest ``numbers`` entry is compared against the median of
      the group's PRIOR values: relative movement beyond ``tolerance``
      is **drift**, inside it stable. Needs >= 2 runs; a single run
      has no trend.

    Returns ``{"groups": {...}, "flips": [...], "drift": [...],
    "runs": N, "ok": bool}`` — ``ok`` is "no flips" (drift is
    advisory; the absolute gates live in the scenario SLOs).
    """
    groups: dict[str, list[dict[str, Any]]] = {}
    for rec in records:
        groups.setdefault(_group_key(rec), []).append(rec)

    flips: list[dict[str, Any]] = []
    drift: list[dict[str, Any]] = []
    group_out: dict[str, Any] = {}
    for gkey, recs in groups.items():
        g_flips: list[dict[str, Any]] = []
        # flips compare against the LAST-KNOWN value per field, not
        # the immediately preceding record: a run that carries no
        # slo_ok (a `record`/`run` append) or omits a digest field
        # interleaved between two checks must not mask a regression
        last_digest: dict[str, tuple[str, Any]] = {}
        last_slo: tuple[str, Any] | None = None
        for cur in recs:
            for name, value in sorted(
                    (cur.get("digests") or {}).items()):
                known = last_digest.get(name)
                if known is not None and known[1] != value:
                    g_flips.append({
                        "group": gkey, "class": "digest",
                        "field": name,
                        "from": known[1], "to": value,
                        "run_from": known[0],
                        "run_to": cur.get("run_id"),
                        "ts": cur.get("ts"),
                    })
                last_digest[name] = (cur.get("run_id"), value)
            slo_ok = cur.get("slo_ok")
            if slo_ok is not None:
                if last_slo is not None and last_slo[1] is True \
                        and slo_ok is False:
                    g_flips.append({
                        "group": gkey, "class": "slo",
                        "field": "slo_ok",
                        "from": True, "to": False,
                        "run_from": last_slo[0],
                        "run_to": cur.get("run_id"),
                        "ts": cur.get("ts"),
                    })
                last_slo = (cur.get("run_id"), slo_ok)
        g_drift: list[dict[str, Any]] = []
        if len(recs) >= 2:
            latest = recs[-1].get("numbers") or {}
            for name in sorted(latest):
                prior = [r["numbers"][name] for r in recs[:-1]
                         if name in (r.get("numbers") or {})]
                if not prior:
                    continue
                ref = statistics.median(prior)
                if ref == 0:
                    continue
                rel = (latest[name] - ref) / abs(ref)
                if abs(rel) > tolerance:
                    g_drift.append({
                        "group": gkey, "field": name,
                        "baseline_median": round(ref, 6),
                        "latest": round(float(latest[name]), 6),
                        "relative": round(rel, 4),
                        "tolerance": tolerance,
                        "run": recs[-1].get("run_id"),
                    })
        flips += g_flips
        drift += g_drift
        group_out[gkey] = {
            "runs": len(recs),
            "first_ts": recs[0].get("ts"),
            "last_ts": recs[-1].get("ts"),
            "last_run_id": recs[-1].get("run_id"),
            "flips": len(g_flips),
            "drift": len(g_drift),
        }

    out = {
        "runs": len(records),
        "groups": group_out,
        "flips": flips,
        "drift": drift,
        "ok": not flips,
    }
    _export_gauges(out)
    return out


def _export_gauges(trend: dict[str, Any]) -> None:
    """Mirror the latest trend scan as ``sbt_history_*`` gauges so a
    scrape-only deployment sees the verdict without reading JSONL.
    Gauges, not counters: a scrape loop re-running the scan must not
    inflate a total."""
    from spark_bagging_tpu_torch import telemetry

    telemetry.set_gauge("sbt_history_records", float(trend["runs"]))
    telemetry.set_gauge("sbt_history_groups",
                        float(len(trend["groups"])))
    telemetry.set_gauge("sbt_history_digest_flips",
                        float(len(trend["flips"])))
    telemetry.set_gauge("sbt_history_numeric_drift",
                        float(len(trend["drift"])))


def history_report(limit: int = 32,
                   path: str | None = None) -> dict[str, Any]:
    """The ``/debug/history`` route body (also the CLI's source): the
    newest ``limit`` records plus the trend verdict over the FULL
    store (trend over a truncated window would miss older flips)."""
    records = read_history(path)
    trend = compare_trend(records)
    limit = max(0, int(limit))
    return {
        "path": path or history_path(),
        "runs": len(records),
        "records": records[-limit:] if limit > 0 else [],
        "trend": trend,
    }


def render_history(report: dict[str, Any]) -> str:
    """Human one-screen rendering for the CLI: per-group run counts
    and verdicts, then any flips/drift in full."""
    lines = [f"history: {report['path']} ({report['runs']} runs)"]
    trend = report["trend"]
    for gkey in sorted(trend["groups"]):
        g = trend["groups"][gkey]
        verdict = "FLIP" if g["flips"] else (
            "drift" if g["drift"] else "stable")
        lines.append(
            f"  [{verdict:>6}] {gkey}: {g['runs']} runs "
            f"(last {g['last_run_id']})"
        )
    for f in trend["flips"]:
        lines.append(
            f"  FLIP {f['group']} {f['field']}: "
            f"{str(f['from'])[:16]} -> {str(f['to'])[:16]} "
            f"({f['run_from']} -> {f['run_to']})"
        )
    for d in trend["drift"]:
        lines.append(
            f"  drift {d['group']} {d['field']}: "
            f"{d['baseline_median']} -> {d['latest']} "
            f"({d['relative']:+.0%} vs ±{d['tolerance']:.0%} band)"
        )
    lines.append("trend OK" if trend["ok"]
                 else "trend DIGEST FLIP detected")
    return "\n".join(lines)
