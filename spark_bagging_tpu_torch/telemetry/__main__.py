"""CLI: ``python -m spark_bagging_tpu_torch.telemetry dump|profile ...``.

With no argument, dumps THIS process's registry in Prometheus text
format (useful from a REPL/notebook via ``%run``; a fresh process has
an empty registry). With a JSONL event-log path (written by
``telemetry.capture(path)``), reconstructs the log's final ``metrics``
snapshot and renders that — the offline way to turn a recorded run
into a scrape-able dump.

``dump --merge a.jsonl b.jsonl ...`` merges SEVERAL per-process logs
into one fleet dump through the exact same merge the live
``FleetAggregator`` uses (``telemetry/fleet.py``): counters sum,
gauges keep per-process values under a ``process=`` label (derived
from each file's name) plus ``fleet=min/max/sum`` aggregates, and
histograms merge bucket-wise — so the dump's ``# quantiles`` lines
are computed from the union of the processes' bucket counts, never
from averaged percentiles.

Every histogram additionally gets a ``# quantiles`` comment line with
its p50/p95/p99 estimate (log-bucket interpolation) — comment lines
are legal in the exposition format, so the output stays scrape-
parseable while a human reading the dump gets the SLO trio for free
(``--no-quantiles`` drops them for byte-stable diffs).

``profile --seconds N [--port P | --url http://host:port]`` triggers
an on-demand live device profile on a RUNNING serving process through
its exposition server's ``/debug/profile`` route (the port defaults
to ``$SBT_METRICS_PORT``): the capture starts immediately, auto-stops
after N seconds (hard-capped server-side), and lands under the
process's ``telemetry_dir()/profiles/`` as a ``torch.profiler`` Chrome
trace — no restart, no code change.
``profile --stop`` ends a running capture early. Exit 1 when the
process already has a capture running (HTTP 409 single-flight).

The port's copy of the JAX package's ``telemetry/__main__.py``: the
same logs merge to the same series in either package (only the
``# HELP`` text of series whose meaning differs on the card differs).
"""

from __future__ import annotations

import argparse
import os
import sys


def _quantile_comments(snapshot: list[dict]) -> str:
    from spark_bagging_tpu_torch.telemetry.registry import snapshot_quantiles

    lines = []
    for entry in snapshot:
        if entry["kind"] != "histogram":
            continue
        qs = snapshot_quantiles(entry)
        labels = "".join(
            f",{k}={v}" for k, v in sorted(entry["labels"].items())
        )
        stats = " ".join(
            f"{k}={'nan' if v is None else format(v, '.6g')}"
            for k, v in qs.items()
        )
        lines.append(f"# quantiles {entry['name']}{labels} {stats}")
    return "\n".join(lines) + ("\n" if lines else "")


def _profile_cmd(p: argparse.ArgumentParser, args) -> int:
    """Drive a remote process's ``/debug/profile`` route (stdlib
    urllib — the CLI must work on an operator box with nothing but
    this package installed)."""
    import json
    import urllib.error
    import urllib.request

    base = args.url
    if base is None:
        port = args.port
        if port is None:
            env = os.environ.get("SBT_METRICS_PORT", "")
            if not env:
                p.error(
                    "no target: pass --port/--url or set "
                    "SBT_METRICS_PORT to the serving process's "
                    "exposition port"
                )
            port = int(env)
        base = f"http://127.0.0.1:{port}"
    if args.stop:
        url = f"{base.rstrip('/')}/debug/profile?action=stop"
    else:
        if args.seconds <= 0:
            p.error(f"--seconds must be > 0, got {args.seconds}")
        url = (f"{base.rstrip('/')}/debug/profile"
               f"?seconds={args.seconds}")
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            body = json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode("utf-8"))
        # sbt-lint: disable=swallowed-fault — the HTTPError itself is the payload: stringified into the body printed to stderr with exit 1 below
        except Exception:  # noqa: BLE001 — a non-JSON error body
            body = {"error": str(e)}
        print(json.dumps(body), file=sys.stderr)
        return 1
    except OSError as e:
        print(f"cannot reach {url!r}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(body))
    if body.get("started"):
        print(
            f"profiling for {args.seconds}s into {body.get('dir')!r} "
            "(auto-stops; view trace.json with perfetto)",
            file=sys.stderr,
        )
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m spark_bagging_tpu_torch.telemetry", description=__doc__
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    dump = sub.add_parser(
        "dump", help="render metrics in Prometheus text format"
    )
    dump.add_argument(
        "jsonl", nargs="*", default=[],
        help="JSONL event log(s) to render (default: this process's "
             "registry; several only with --merge)",
    )
    dump.add_argument(
        "--merge", action="store_true",
        help="merge the per-process snapshots of SEVERAL event logs "
             "into one fleet dump (the FleetAggregator's exact merge: "
             "counters sum, gauges get process= labels + fleet "
             "min/max/sum, histograms merge bucket-wise)",
    )
    dump.add_argument(
        "--no-quantiles", action="store_true",
        help="omit the per-histogram `# quantiles` comment lines",
    )
    prof = sub.add_parser(
        "profile",
        help="trigger an on-demand live device profile on a running "
             "serving process via its /debug/profile route",
    )
    prof.add_argument(
        "--seconds", type=float, default=5.0,
        help="capture duration; the server auto-stops the profiler "
             "after this (clamped to its hard max)",
    )
    prof.add_argument(
        "--port", type=int, default=None,
        help="exposition-server port on localhost "
             "(default: $SBT_METRICS_PORT)",
    )
    prof.add_argument(
        "--url", default=None,
        help="full base URL of the exposition server "
             "(overrides --port)",
    )
    prof.add_argument(
        "--stop", action="store_true",
        help="stop the process's running capture instead of starting "
             "one",
    )
    args = p.parse_args(argv)

    if args.cmd == "profile":
        return _profile_cmd(p, args)

    from spark_bagging_tpu_torch import telemetry

    def _read_snapshot(path: str):
        events = telemetry.read_events(path)
        snap = telemetry.last_metrics_snapshot(events)
        if snap is None:
            print(
                f"no metrics snapshot found in {path!r} "
                "(was the capture closed?)", file=sys.stderr,
            )
        return snap

    if args.merge:
        if not args.jsonl:
            p.error("--merge needs at least one JSONL event log")
        from spark_bagging_tpu_torch.telemetry import fleet

        named = []
        seen: dict[str, int] = {}
        for path in args.jsonl:
            snap = _read_snapshot(path)
            if snap is None:
                return 1
            # process label from the file name; duplicates get a
            # #index suffix so two runs named telemetry.jsonl stay
            # distinguishable in the merged gauges
            base = os.path.basename(path)
            for suffix in (".workload.jsonl", ".jsonl"):
                if base.endswith(suffix):
                    base = base[: -len(suffix)]
                    break
            n = seen.get(base, 0)
            seen[base] = n + 1
            named.append((base if n == 0 else f"{base}#{n}", snap))
        snap, dropped = fleet.merge_snapshots(named)
        for name in dropped:
            print(
                f"dropped {name!r}: processes disagree on metric kind "
                "or histogram bounds (cannot merge exactly)",
                file=sys.stderr,
            )
    elif not args.jsonl:
        snap = telemetry.registry().snapshot()
    elif len(args.jsonl) > 1:
        p.error("several event logs need --merge")
    else:
        snap = _read_snapshot(args.jsonl[0])
        if snap is None:
            return 1
    sys.stdout.write(telemetry.render_prometheus(snap))
    if not args.no_quantiles:
        sys.stdout.write(_quantile_comments(snap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
