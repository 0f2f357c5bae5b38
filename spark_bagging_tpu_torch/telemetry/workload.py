"""Workload capture: turn live serving traffic into a replayable file.

Every served request is traceable; this module makes the request
STREAM itself a first-class artifact. A
:class:`WorkloadRecorder` subscribes to the process event stream
(the same sink seam the JSONL capture and the flight recorder use) and
records one entry per ``serving_request`` arrival event emitted by
``MicroBatcher.submit()``: relative arrival time, row count,
dtype/width, the shape bucket the rows map to, and a concurrency
epoch. The result serializes as a versioned ``*.workload.jsonl`` that
a replayer can run deterministically against a real serving stack —
overload behavior, tail latency, and padding waste become regression
tests instead of incidents — and :meth:`WorkloadRecorder.drain` hands
the recent window to the online trainer's refit transcript.

File format (``WORKLOAD_SCHEMA_VERSION``): line 1 is a header object
(``kind="workload_header"``, schema version, source, generator/seed
for synthetic workloads, request count, duration, feature width);
every following line is one request::

    {"t": 0.0135, "rows": 2, "width": 32, "dtype": "float32",
     "bucket": 8, "epoch": 0}

- ``t`` — arrival time in seconds relative to the first request
  (monotonic clock at capture; the replayer's virtual clock).
- ``bucket`` — the executor ladder rung ``rows`` maps to at capture
  time (padding-waste attribution without re-deriving ladder bounds);
  ``null`` when the serving stack had no bucket ladder.
- ``epoch`` — concurrency epoch: increments whenever the gap since
  the previous arrival exceeds ``epoch_gap_s`` (default 1 s). Distinct
  epochs are distinct traffic waves — the replayer and the online
  trainer can treat them as independent load regimes.

When no capture exists, :func:`synthetic_workload` generates one from
a seeded arrival model (``poisson`` / ``bursty`` / ``diurnal``) — same
seed, same workload, byte-for-byte identical entries.

The port's copy of the JAX package's ``telemetry/workload.py``: the
file format is the same, so a ``*.workload.jsonl`` written by either
package loads in the other.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Iterable

from spark_bagging_tpu_torch.analysis.locks import make_lock

WORKLOAD_SCHEMA_VERSION = 1

#: Default gap (seconds) between arrivals that starts a new
#: concurrency epoch.
DEFAULT_EPOCH_GAP_S = 1.0


class WorkloadRequest:
    """One recorded (or generated) request arrival."""

    __slots__ = ("t", "rows", "width", "dtype", "bucket", "epoch")

    def __init__(self, t: float, rows: int, width: int | None,
                 dtype: str = "float32", bucket: int | None = None,
                 epoch: int = 0) -> None:
        self.t = float(t)
        self.rows = int(rows)
        self.width = None if width is None else int(width)
        self.dtype = str(dtype)
        self.bucket = None if bucket is None else int(bucket)
        self.epoch = int(epoch)

    def to_dict(self) -> dict[str, Any]:
        return {
            "t": self.t, "rows": self.rows, "width": self.width,
            "dtype": self.dtype, "bucket": self.bucket,
            "epoch": self.epoch,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "WorkloadRequest":
        return cls(
            t=d["t"], rows=d["rows"], width=d.get("width"),
            dtype=d.get("dtype", "float32"), bucket=d.get("bucket"),
            epoch=d.get("epoch", 0),
        )

    def __repr__(self) -> str:
        return (f"WorkloadRequest(t={self.t:.4f}, rows={self.rows}, "
                f"epoch={self.epoch})")


class Workload:
    """An ordered request stream plus its provenance header."""

    def __init__(
        self,
        requests: Iterable[WorkloadRequest],
        *,
        source: str = "capture",
        generator: str | None = None,
        seed: int | None = None,
        created_ts: float | None = None,
    ) -> None:
        self.requests = sorted(requests, key=lambda r: r.t)
        self.source = source
        self.generator = generator
        self.seed = seed
        self.created_ts = created_ts

    # -- derived facts -------------------------------------------------

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].t if self.requests else 0.0

    @property
    def total_rows(self) -> int:
        return sum(r.rows for r in self.requests)

    def summary(self) -> dict[str, Any]:
        """JSON-friendly digest (live views, replay reports)."""
        rows = [r.rows for r in self.requests]
        dur = self.duration_s
        return {
            "schema": WORKLOAD_SCHEMA_VERSION,
            "source": self.source,
            "generator": self.generator,
            "seed": self.seed,
            "n_requests": self.n_requests,
            "duration_s": round(dur, 6),
            "total_rows": self.total_rows,
            "mean_rps": (round(self.n_requests / dur, 2) if dur > 0
                         else None),
            "rows_min": min(rows) if rows else None,
            "rows_max": max(rows) if rows else None,
            "n_epochs": (self.requests[-1].epoch + 1 if self.requests
                         else 0),
        }

    # -- (de)serialization ---------------------------------------------

    def header(self) -> dict[str, Any]:
        return {
            "kind": "workload_header",
            "schema": WORKLOAD_SCHEMA_VERSION,
            "source": self.source,
            "generator": self.generator,
            "seed": self.seed,
            "n_requests": self.n_requests,
            "duration_s": self.duration_s,
            "width": (self.requests[0].width if self.requests else None),
            "created_ts": self.created_ts,
        }

    def save(self, path: str) -> str:
        """Write the versioned ``*.workload.jsonl`` (header line first,
        then one line per request, arrival order). Returns ``path``."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.header(), f)
            f.write("\n")
            for r in self.requests:
                json.dump(r.to_dict(), f)
                f.write("\n")
        os.replace(tmp, path)  # a replayer never sees a torn file
        return path


def load_workload(path: str) -> Workload:
    """Parse a ``*.workload.jsonl`` back into a :class:`Workload`.

    Loud on malformed input: a replay against a torn or
    wrong-schema-version file must fail before it produces numbers
    someone gates a deploy on.
    """
    with open(path) as f:
        first = f.readline().strip()
        if not first:
            raise ValueError(f"{path}: empty workload file")
        header = json.loads(first)
        if header.get("kind") != "workload_header":
            raise ValueError(
                f"{path}: first line is not a workload_header "
                f"(got kind={header.get('kind')!r})"
            )
        schema = header.get("schema")
        if schema != WORKLOAD_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: workload schema {schema!r} not supported "
                f"(this build reads {WORKLOAD_SCHEMA_VERSION})"
            )
        requests = []
        for line in f:
            line = line.strip()
            if line:
                requests.append(WorkloadRequest.from_dict(json.loads(line)))
    wl = Workload(
        requests,
        source=header.get("source", "capture"),
        generator=header.get("generator"),
        seed=header.get("seed"),
        created_ts=header.get("created_ts"),
    )
    declared = header.get("n_requests")
    if declared is not None and declared != wl.n_requests:
        raise ValueError(
            f"{path}: header declares {declared} requests but the file "
            f"holds {wl.n_requests} — truncated capture?"
        )
    return wl


def assign_epochs(requests: list[WorkloadRequest],
                  gap_s: float = DEFAULT_EPOCH_GAP_S) -> None:
    """Assign concurrency epochs in place: a gap larger than ``gap_s``
    between consecutive arrivals starts a new epoch (a new traffic
    wave)."""
    epoch = 0
    prev_t: float | None = None
    for r in requests:
        if prev_t is not None and r.t - prev_t > gap_s:
            epoch += 1
        r.epoch = epoch
        prev_t = r.t


# -- the live recorder --------------------------------------------------

# sbt-lint: shared-state
class WorkloadRecorder:
    """Subscribe to the event stream and capture the request arrivals.

    Implements the sink protocol (``emit(event)``) like the flight
    recorder; only ``serving_request`` events (emitted by
    ``MicroBatcher.submit`` whenever an arrival consumer is active —
    :func:`capture_active` is the gate the batcher checks) are
    recorded — spans, metrics flushes, and fault events pass through
    untouched. ``capacity`` bounds memory (oldest entries drop with a
    one-time truncation mark in :meth:`summary`); arrival times are
    re-based to the first recorded event.
    """

    def __init__(self, *, capacity: int = 1_000_000,
                 epoch_gap_s: float = DEFAULT_EPOCH_GAP_S) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.epoch_gap_s = float(epoch_gap_s)
        self._lock = make_lock("telemetry.workload")
        # a deque ring, not a list: eviction at capacity must stay
        # O(1) per arrival — this sink sits on the submit path of a
        # LIVE serving process, and a recorder pinned at capacity
        # would otherwise pay O(capacity) per request
        self._entries: deque[WorkloadRequest] = deque(maxlen=self.capacity)
        self._t0: float | None = None
        self._prev_t: float | None = None
        self._epoch = 0
        self._dropped = 0
        # running aggregates over EVERYTHING seen (evicted entries
        # included): summary() reads these instead of copying the ring
        # — it shares this lock with emit() on the live submit path,
        # so a live-view scrape must stay O(1), not O(capacity)
        self._n_seen = 0
        self._total_rows = 0
        self._rows_min: int | None = None
        self._rows_max: int | None = None
        self._recording = False
        self.t_started: float | None = None

    # -- sink protocol -------------------------------------------------

    def emit(self, event: dict) -> None:
        if event.get("kind") != "serving_request":
            return
        t_mono = event.get("t_mono")
        if t_mono is None:  # a hand-rolled event without the clock stamp
            t_mono = time.monotonic()
        with self._lock:
            if self._t0 is None:
                self._t0 = t_mono
            t = t_mono - self._t0
            if self._prev_t is not None and t - self._prev_t > self.epoch_gap_s:
                self._epoch += 1
            self._prev_t = t
            if len(self._entries) == self.capacity:
                self._dropped += 1  # the append below evicts the oldest
            rows = int(event.get("rows", 1))
            self._n_seen += 1
            self._total_rows += rows
            if self._rows_min is None or rows < self._rows_min:
                self._rows_min = rows
            if self._rows_max is None or rows > self._rows_max:
                self._rows_max = rows
            self._entries.append(WorkloadRequest(
                t=t,
                rows=rows,
                width=event.get("width"),
                dtype=str(event.get("dtype", "float32")),
                bucket=event.get("bucket"),
                epoch=self._epoch,
            ))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "WorkloadRecorder":
        """Begin a capture session (idempotent while recording).

        A start after a :meth:`stop` is a NEW session, never a resume:
        the previous session's data was already handed out by stop()
        (and stays readable via :meth:`workload` until this call), so
        the entries, t=0 anchor, epoch counter, and aggregates all
        reset — otherwise the second session's arrivals would carry
        the whole inter-session wall gap as schedule time. Recording
        requires telemetry to be enabled — arrival events are only
        emitted behind the ``telemetry.enabled()`` gate."""
        global _n_recording
        from spark_bagging_tpu_torch.telemetry.state import STATE

        if not STATE.enabled:
            import warnings

            # subscribe anyway (telemetry may be re-enabled mid-
            # session), but a capture opened while the arrival events
            # it depends on are switched off deserves a loud heads-up
            # — the alternative is an operator discovering an empty
            # workload file after the incident they meant to record
            warnings.warn(
                "workload recording started while telemetry is "
                "disabled: serving arrival events are not emitted, so "
                "this capture will stay EMPTY until telemetry.enable()",
                RuntimeWarning,
                stacklevel=2,
            )
        with self._lock:
            already = self._recording
            if not already:
                self._entries.clear()
                self._t0 = None
                self._prev_t = None
                self._epoch = 0
                self._dropped = 0
                self._n_seen = 0
                self._total_rows = 0
                self._rows_min = None
                self._rows_max = None
                self._recording = True
                self.t_started = time.time()
        if not already:
            with _interest_lock:
                _n_recording += 1
                _recording_instances.append(self)
            STATE.add_sink(self)
        return self

    def stop(self) -> Workload:
        """Detach and return the captured :class:`Workload`."""
        global _n_recording
        from spark_bagging_tpu_torch.telemetry.state import STATE

        with self._lock:
            was = self._recording
            self._recording = False
        if was:
            with _interest_lock:
                _n_recording -= 1
                if self in _recording_instances:
                    _recording_instances.remove(self)
            STATE.remove_sink(self)
        return self.workload()

    @property
    def recording(self) -> bool:
        return self._recording

    # -- introspection -------------------------------------------------

    def workload(self) -> Workload:
        with self._lock:
            entries = list(self._entries)
        return Workload(entries, source="capture",
                        created_ts=self.t_started)

    def drain(self, max_requests: int | None = None) -> list[WorkloadRequest]:
        """Consume the captured window: return up to ``max_requests``
        of the MOST RECENT recorded arrivals and remove everything
        returned from the ring (recording continues; the running
        aggregates keep covering the whole seen stream). This is the
        online trainer's hand-off seam — each drift-triggered refit
        drains the traffic window that tripped the alert, and the next
        refit starts from an empty window instead of re-consuming the
        same incident. Returned entries are arrival records (schedule
        + shapes), the refit transcript's bookkeeping; payloads and
        labels ride the trainer's :class:`~spark_bagging_tpu_torch.online
        .trainer.LabeledBuffer`, which the serving edge feeds."""
        import itertools

        with self._lock:
            entries = list(self._entries)
            if max_requests is not None and max_requests >= 0:
                entries = entries[-max_requests:] if max_requests else []
            if entries:
                # islice, never per-index deque access: this lock sits
                # on the live submit path, and rebuilding the kept
                # prefix by indexing would be O(keep²) inside it
                keep = len(self._entries) - len(entries)
                kept = list(itertools.islice(self._entries, keep))
                self._entries.clear()
                self._entries.extend(kept)
        return entries

    def summary(self) -> dict[str, Any]:
        """Live digest: the captured stream so far,
        plus recorder state. Built from running aggregates — O(1)
        under the lock emit() shares, so scraping it mid-traffic never
        stalls concurrent ``submit()`` calls (aggregates cover the
        whole SEEN stream; ``n_requests`` is the ring, ``dropped`` the
        evicted difference)."""
        with self._lock:
            dur = self._prev_t or 0.0
            return {
                "schema": WORKLOAD_SCHEMA_VERSION,
                "source": "capture",
                "generator": None,
                "seed": None,
                "n_requests": len(self._entries),
                "n_seen": self._n_seen,
                "duration_s": round(dur, 6),
                "total_rows": self._total_rows,
                "mean_rps": (round(self._n_seen / dur, 2) if dur > 0
                             else None),
                "rows_min": self._rows_min,
                "rows_max": self._rows_max,
                "n_epochs": self._epoch + 1 if self._n_seen else 0,
                "recording": self._recording,
                "capacity": self.capacity,
                "dropped": self._dropped,
                "t_started": self.t_started,
            }

    def save(self, path: str) -> str:
        return self.workload().save(path)


# every RECORDING WorkloadRecorder instance (default or direct), in
# start order: the batcher's submit path gates arrival-event
# construction on the count (via telemetry.arrival_events_wanted),
# and :func:`active` resolves its live view from it — a directly-
# constructed recorder (the documented alternative to the default)
# must be just as visible as the default one
_interest_lock = make_lock("telemetry.workload.interest")
_n_recording = 0
_recording_instances: list["WorkloadRecorder"] = []


def capture_active() -> bool:
    """True while ANY workload recorder is recording (a bare int read
    — this sits on the serving submit path)."""
    return _n_recording > 0


_default: WorkloadRecorder | None = None
# concurrent first record() calls must not each subscribe a recorder —
# the loser would be an undetachable sink double-counting arrivals
# (same hazard the flight recorder's default lock guards against)
_default_lock = make_lock("telemetry.workload.default")


def record(**kwargs: Any) -> WorkloadRecorder:
    """Start the process-default recorder: returns the live one if a
    capture session is running, else creates a FRESH recorder. A
    stopped default — whether via module-level :func:`stop` or the
    instance's own ``stop()`` — is a finished session, never resumed:
    its entries, t=0 anchor, and epoch counter must not bleed into
    the next capture. ``kwargs`` are :class:`WorkloadRecorder` options
    and apply whenever a fresh recorder is created; passing them while
    a session is LIVE warns instead of silently dropping them."""
    global _default
    with _default_lock:
        if _default is None or not _default.recording:
            _default = WorkloadRecorder(**kwargs)
        elif kwargs:
            import warnings

            warnings.warn(
                "a workload recording session is live; record() "
                f"options {sorted(kwargs)} are ignored (stop() the "
                "default first, or construct WorkloadRecorder "
                "directly)",
                RuntimeWarning,
                stacklevel=2,
            )
        rec = _default
        # start INSIDE the lock: a concurrent record() racing this one
        # must see recording=True, not conclude "stopped session" and
        # replace a recorder whose sink subscription is in flight
        rec.start()
    return rec


def stop() -> Workload | None:
    """Stop AND retire the process-default recorder; returns its
    workload (or None when none was ever started). Retiring matters:
    a capture session ends here, so the next :func:`record` starts a
    FRESH recorder — entries, the t=0 anchor, and the epoch counter
    from the previous session must not bleed into it."""
    global _default
    with _default_lock:
        rec = _default
        _default = None
    if rec is None:
        return None
    return rec.stop()


def active() -> WorkloadRecorder | None:
    """A recorder that is currently recording, or None: the process
    default when its session
    is live, else the most recently started recording instance — a
    directly-constructed ``WorkloadRecorder().start()`` (the
    documented alternative when the default is busy) is just as
    visible to the live view as the default one."""
    rec = _default
    if rec is not None and rec.recording:
        return rec
    with _interest_lock:
        return _recording_instances[-1] if _recording_instances else None


# -- synthetic workloads ------------------------------------------------

def _draw_rows(rng, rows) -> int:
    if isinstance(rows, int):
        return rows
    seq = list(rows)
    return int(seq[int(rng.integers(0, len(seq)))])


def synthetic_workload(
    kind: str = "poisson",
    *,
    rate_rps: float = 200.0,
    duration_s: float = 1.0,
    seed: int = 0,
    rows: int | tuple[int, ...] = 1,
    width: int = 16,
    bucket_bounds: tuple[int, int] | None = None,
    burst_every_s: float = 0.25,
    burst_size: int = 32,
    diurnal_period_s: float | None = None,
    diurnal_depth: float = 0.8,
    epoch_gap_s: float = DEFAULT_EPOCH_GAP_S,
) -> Workload:
    """Generate a seeded arrival schedule when no capture exists.

    ``kind``:

    - ``"poisson"`` — homogeneous Poisson arrivals at ``rate_rps``
      (exponential inter-arrival gaps): steady open-loop traffic.
    - ``"bursty"`` — the Poisson base plus a burst of ``burst_size``
      near-simultaneous requests every ``burst_every_s``: the overload
      / backpressure scenario.
    - ``"diurnal"`` — inhomogeneous Poisson whose rate swings
      sinusoidally (``rate_rps * (1 + diurnal_depth * sin)``, period
      ``diurnal_period_s`` defaulting to the full duration): the
      slow-tide load shape, generated by thinning.

    ``rows`` is a fixed per-request row count or a tuple of choices
    (uniform). Deterministic: same arguments + same seed produce
    byte-identical workloads (``numpy.random.default_rng(seed)`` is
    the only randomness source — no wall clock anywhere).
    """
    import numpy as np

    if rate_rps <= 0 or duration_s <= 0:
        raise ValueError(
            f"need rate_rps > 0 and duration_s > 0, got "
            f"{rate_rps}, {duration_s}"
        )
    rng = np.random.default_rng(seed)
    times: list[float] = []
    if kind == "poisson":
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate_rps))
            if t > duration_s:
                break
            times.append(t)
    elif kind == "bursty":
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate_rps))
            if t > duration_s:
                break
            times.append(t)
        n_bursts = int(duration_s / burst_every_s)
        for b in range(1, n_bursts + 1):
            t_b = b * burst_every_s
            if t_b > duration_s:
                break
            # a burst is near-simultaneous, not exactly simultaneous:
            # spread over ~1 ms so arrival order stays well-defined
            offs = np.sort(rng.uniform(0.0, 1e-3, size=burst_size))
            times.extend(float(t_b + o) for o in offs)
    elif kind == "diurnal":
        period = diurnal_period_s or duration_s
        if not 0.0 <= diurnal_depth <= 1.0:
            raise ValueError(
                f"diurnal_depth must be in [0, 1], got {diurnal_depth}"
            )
        # thinning: draw from the peak rate, keep with p = rate(t)/peak
        peak = rate_rps * (1.0 + diurnal_depth)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t > duration_s:
                break
            rate_t = rate_rps * (
                1.0 + diurnal_depth * math.sin(2.0 * math.pi * t / period)
            )
            if float(rng.uniform()) < rate_t / peak:
                times.append(t)
    else:
        raise ValueError(
            f"unknown workload kind {kind!r}; "
            "have poisson, bursty, diurnal"
        )

    times.sort()
    requests = []
    for t in times:
        n = _draw_rows(rng, rows)
        bucket = None
        if bucket_bounds is not None:
            from spark_bagging_tpu_torch.serving.buckets import bucket_for

            bucket = bucket_for(n, *bucket_bounds)
        requests.append(WorkloadRequest(
            t=t, rows=n, width=width, dtype="float32", bucket=bucket,
        ))
    assign_epochs(requests, epoch_gap_s)
    return Workload(requests, source="synthetic", generator=kind,
                    seed=seed)
