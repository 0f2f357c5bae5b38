"""Event sinks: the per-run JSONL event log and the run registry.

A **run** is one observed window (typically one ``fit``/bench
invocation) opened with :func:`capture`. While open, every span event
and metric flush is delivered to the run's sink; the sink keeps the
events in memory (``run.events``) and, when a path was given, appends
them to a JSONL file — one JSON object per line, ``schema``-versioned
so downstream tooling can evolve the format without guessing.

Event kinds (all carry ``schema``/``run``/``ts``):

- ``run_start`` / ``run_end`` — window boundaries; ``run_end`` carries
  the wall-clock of the window.
- ``span`` — one completed phase span (``name``, ``path``, ``seconds``,
  ``sync``, optional ``attrs``).
- ``metrics`` — a full registry snapshot (flushed at ``run_end``, and
  on demand via ``Run.flush_metrics()``), the machine-readable
  instrument panel BENCH trajectories diff against.

The process-level **run registry** (:func:`runs`, :func:`current_run`)
lists every run opened in this process so late readers (a REPL, an
exception handler) can correlate events with the run that produced
them.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Iterator

SCHEMA_VERSION = 1


def telemetry_dir() -> str:
    """The directory run artifacts (JSONL event logs, flight-recorder
    dumps) land in: ``$SBT_TELEMETRY_DIR`` when set, else
    ``./telemetry/`` under the current working directory. Created on
    first use — artifacts are working state, not source, and live
    outside version control (``.gitignore`` covers the default)."""
    path = os.environ.get("SBT_TELEMETRY_DIR") or os.path.join(
        os.getcwd(), "telemetry"
    )
    os.makedirs(path, exist_ok=True)
    return path


def default_log_path(name: str = "telemetry.jsonl") -> str:
    """``name`` resolved inside :func:`telemetry_dir` — what bench.py
    and the serving benchmark pass to :func:`capture` by default."""
    return os.path.join(telemetry_dir(), name)


_run_seq = itertools.count(1)
_runs_lock = threading.Lock()
_runs: list["Run"] = []


# With a file sink attached, the in-memory mirror keeps only this many
# events — a multi-epoch out-of-core stream emits one span per chunk,
# and duplicating millions of event dicts on the host would OOM exactly
# the workloads the streaming engine exists for. The JSONL file stays
# complete; `n_events` counts everything.
MAX_MIRRORED_EVENTS = 10_000


class Run:
    """One capture window: in-memory event list + optional JSONL file.

    ``events`` mirrors the stream in memory, capped at
    ``MAX_MIRRORED_EVENTS`` when a file sink is attached (the file gets
    every event; ``n_events`` is the true total). File-less captures
    keep everything — they ARE the sink.
    """

    def __init__(self, path: str | None, label: str | None) -> None:
        self.run_id = f"run-{os.getpid()}-{next(_run_seq)}"
        self.label = label
        self.path = path
        self.events: list[dict] = []
        self.n_events = 0
        self.t_start = time.time()
        self._lock = threading.Lock()
        self._file = open(path, "a", buffering=1) if path else None

    def emit(self, event: dict) -> None:
        event = {
            "schema": SCHEMA_VERSION,
            "run": self.run_id,
            **event,
        }
        event.setdefault("ts", time.time())
        with self._lock:
            self.n_events += 1
            if (self._file is None
                    or len(self.events) < MAX_MIRRORED_EVENTS):
                self.events.append(event)
            if self._file is not None:
                json.dump(event, self._file, default=str)
                self._file.write("\n")

    def flush_metrics(self) -> None:
        """Append a full registry snapshot as one ``metrics`` event."""
        from spark_bagging_tpu_torch.telemetry.state import STATE

        self.emit({"kind": "metrics", "metrics": STATE.registry.snapshot()})

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def spans(self, name: str | None = None) -> list[dict]:
        """Recorded span events, optionally filtered by name."""
        return [
            e for e in self.events
            if e["kind"] == "span" and (name is None or e["name"] == name)
        ]


def runs() -> list[Run]:
    """Every run opened in this process, in open order."""
    with _runs_lock:
        return list(_runs)


_active: list[Run] = []


def current_run() -> Run | None:
    """The innermost open capture, or None."""
    with _runs_lock:
        return _active[-1] if _active else None


def capture_open() -> bool:
    """True while any ``capture()`` window is open. Lock-free read of
    the active list's truthiness — this sits on per-request gates
    (serving arrival events), where a benign race beats a lock."""
    return bool(_active)


@contextmanager
def capture(
    path: str | None = None,
    *,
    label: str | None = None,
    device_sync: bool | None = None,
) -> Iterator[Run]:
    """Open a telemetry run: events recorded while the block runs are
    collected on the returned :class:`Run` (and appended to ``path``
    as JSONL when given — APPENDED, so one file can accumulate many
    runs, distinguished by their ``run`` ids; unlink it first for a
    fresh log, as bench.py does). Captures nest; each event goes to
    every open capture. Opening a capture force-enables telemetry for
    its duration (an explicit observation request beats the ambient
    switch); ``device_sync`` optionally opts span timing into device
    barriers for the window.
    """
    from spark_bagging_tpu_torch.telemetry.state import STATE

    run = Run(path, label)
    prev_enabled = STATE.enabled
    prev_sync = STATE.device_sync
    STATE.enabled = True
    if device_sync is not None:
        STATE.device_sync = device_sync
    with _runs_lock:
        _runs.append(run)
        _active.append(run)
    STATE.add_sink(run)
    run.emit({"kind": "run_start", "label": label})
    try:
        yield run
    finally:
        run.flush_metrics()
        run.emit({
            "kind": "run_end",
            "seconds": time.time() - run.t_start,
            "n_events": run.n_events + 1,
        })
        STATE.remove_sink(run)
        with _runs_lock:
            if run in _active:
                _active.remove(run)
        STATE.enabled = prev_enabled
        STATE.device_sync = prev_sync
        run.close()


def read_events(path: str) -> list[dict]:
    """Parse a JSONL event log back into event dicts (blank lines
    skipped; raises on malformed lines — a torn log should be loud)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def last_metrics_snapshot(events: list[dict]) -> list[dict] | None:
    """The final registry snapshot recorded in an event list, or None."""
    for e in reversed(events):
        if e.get("kind") == "metrics":
            return e["metrics"]
    return None
