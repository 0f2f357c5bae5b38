"""Micro-batching request coalescer — many submitters, one device forward.

Online traffic arrives as many small concurrent requests; the paper's
aggregation story ("vote/mean over replicas is ONE batched forward")
only pays when those requests ride one program launch. The
``MicroBatcher`` owns a bounded request queue and a single worker
thread: the worker takes the first waiting request, keeps gathering
until ``max_delay_ms`` elapses or ``max_batch_rows`` accumulate,
packs the request blocks into the executor's ragged slab plan
(``EnsembleExecutor.forward_parts`` — row-offset scatter, no
concatenate-then-pad double copy), then delivers each block's slice
of the output to its per-request future.

Coalescing only pays when there is someone to coalesce WITH. At
concurrency 1 the queue+worker+future handoff is pure overhead, so
the batcher adapts (**adaptive direct dispatch**): after a streak of
one-request batches proves the delay window is buying nothing, a
submit that finds nothing in flight runs the forward inline on the
caller's thread — naive-dispatch cost, no queue, no handoff. The
decision is a lock-light occupancy counter plus the singleton streak
(one short ``Lock`` held for counter ops only); the first contended
submit, or the first multi-request batch, revokes direct mode on the
spot. Starting in coalescing mode matters: a single-threaded async
dispatcher keeping N futures in flight would be SERIALIZED by inline
serving (each submit would resolve before the next), and the
evidence rule keeps it coalescing because its batches are never
singletons. ``sbt_serving_direct_dispatch_total`` /
``sbt_serving_coalesced_total`` (and the ``path`` label on the
latency histogram) make the split observable.

Contracts that matter under load:

- **Backpressure is explicit.** ``submit`` never blocks: a full queue
  raises :class:`Overloaded` immediately (and counts
  ``sbt_serving_overloaded_total`` plus
  ``sbt_serving_shed_total{reason="overload"}``) so callers shed load
  at the edge instead of silently queueing into timeout territory.
- **Deadlines shed distinctly.** ``submit(X, deadline_ms=...)`` stamps
  a per-request deadline; a request still queued when its batch is
  claimed past the deadline fails with :class:`DeadlineExceeded`
  (``sbt_serving_shed_total{reason="deadline"}``) — "too slow" is a
  different incident than "too full", and the shed accounting keeps
  them apart.
- **Failure is per-request, not fatal.** An executor exception fails
  at most the requests that caused it: transient failures (anything
  raised with ``transient=True``, e.g. ``faults.TransientFault``)
  retry with bounded exponential backoff (``retries=``,
  ``sbt_serving_retries_total``), and a batch that still fails
  **bisects** — each half is served independently, recursively, until
  the one poisoned request fails alone
  (``sbt_serving_batch_bisects_total``) while its batch-mates are
  served normally. The worker keeps serving through all of it.
- **The worker is supervised.** A crash that escapes the per-batch
  guard (a wedged sink, an injected fault) is caught by the
  supervisor: the crash is counted + flight-recorded and a fresh
  worker thread takes over (``sbt_serving_worker_restarts_total``).
  ``crash_loop_threshold`` crashes inside ``crash_loop_window_s``
  instead trip **degraded reject mode**: one ``serving_crash_loop``
  flight dump, ``/healthz`` 503, and every further ``submit()`` shed
  with :class:`Degraded`
  (``sbt_serving_shed_total{reason="degraded"}``) until an operator
  calls :meth:`MicroBatcher.revive`.
- **Hot-swap-safe.** The executor is resolved from a provider ONCE per
  micro-batch, so a registry ``swap()`` takes effect at the next batch
  boundary while requests already forwarded finish on the executor
  they started with — no request is ever dropped by a swap.
- **Every request is traceable.** ``submit()`` mints a trace context
  (``telemetry.tracing``) exposed as ``future.trace``: after the
  future resolves, ``future.trace.breakdown`` attributes the latency
  (``queue_ms``/``batch_ms``/``forward_ms``/``total_ms``) and names
  the batch (``batch_size``, ``bucket``, ``model_version``); span
  events carry the ids, and batch failures / overload rejections emit
  flight-recorder trigger events. All of it vanishes when telemetry
  is disabled (``future.trace is None``).
- **The arrival stream is capturable.** While an open ``capture()``
  window is listening, ``submit()`` also emits one ``serving_request``
  event (rows, width, dtype, bucket, queue depth, monotonic arrival
  stamp). No consumer, no event, no cost.
- **Replay can step it deterministically.** ``threaded=False`` starts
  no worker thread; the owner drives batching explicitly with
  :meth:`run_pending`, which drains the queue into batches by the
  same row rule the worker uses — but on the caller's thread, with no
  timing dependence, so a replay harness gets identical batch
  composition (and therefore bitwise-identical outputs) on every run.

The port's copy of the JAX package's ``serving/batcher.py``, with only
its seams swapped: the exposition server's ``/healthz`` registration,
the performance-attribution probe and the workload recorder's arrival
events are ROADMAP Queue A 15 (``health()`` and ``stats()`` report the
same facts directly).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty, Full, Queue
from typing import Any, Callable

import numpy as np

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.serving.buckets import bucket_for, pack_plan
from spark_bagging_tpu_torch.telemetry import tracing

_SHUTDOWN = object()


class Overloaded(RuntimeError):
    """The batcher's request queue is full — shed this request.

    Raised by :meth:`MicroBatcher.submit` instead of blocking: under
    sustained overload a bounded queue must reject at the edge, or
    every request degrades to worst-case latency together.
    """


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline_ms`` expired while it waited in queue —
    shed as "too slow", distinct from :class:`Overloaded`'s "too full"
    (separate ``sbt_serving_shed_total{reason=}`` labels and event
    kinds)."""


class Degraded(RuntimeError):
    """The batcher is in degraded reject mode: its worker crash-looped
    (``crash_loop_threshold`` crashes inside ``crash_loop_window_s``)
    and requests are shed at the edge until an operator calls
    :meth:`MicroBatcher.revive` after remediation."""


class _Failed:
    """Per-request failure sentinel inside a served batch's outputs —
    how retry/bisect recovery reports 'this one request failed' without
    failing its batch-mates."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class _Request:
    __slots__ = ("X", "n", "mode", "future", "t_submit", "trace",
                 "deadline_t", "poisoned")

    def __init__(self, X: np.ndarray, mode: str,
                 trace: "tracing.TraceContext | None",
                 deadline_t: float | None = None):
        self.X = X
        self.n = X.shape[0]
        self.mode = mode
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # absolute deadline on the batcher's clock (None: no deadline)
        self.deadline_t = deadline_t
        # set by an armed fault plan (chaos experiments only): this
        # request's forward fails until bisection isolates it
        self.poisoned = False
        # per-request trace context (None when telemetry is disabled);
        # mirrored onto the future so callers can read
        # `future.trace.breakdown` after the result resolves
        self.trace = trace
        self.future.trace = trace  # type: ignore[attr-defined]


# sbt-lint: shared-state
class MicroBatcher:
    """Coalesce concurrent ``submit()`` calls into bucketed forwards.

    ``executor`` is an :class:`~spark_bagging_tpu_torch.serving.executor.
    EnsembleExecutor` — or a zero-arg callable returning the current
    one (the registry's hot-swap hook).

    ``max_delay_ms`` bounds the extra latency any request pays waiting
    for batch-mates; ``max_batch_rows`` bounds one forward's row count;
    ``max_queue`` bounds requests admitted but not yet forwarded
    (beyond it, :class:`Overloaded`).

    ``idle_flush_ms`` is how long the worker lingers on an EMPTY queue
    before launching what it has. Closed-loop clients (submit, wait,
    repeat) all go quiet once their wave is enqueued — waiting out the
    full ``max_delay_ms`` window after that is pure added latency with
    zero extra coalescing, so the default flushes fast; raise it toward
    ``max_delay_ms`` when clients are open-loop and stragglers trickle
    in, lower it to 0 to launch the instant the queue empties.

    ``direct_dispatch`` (default: on exactly when ``threaded``) is the
    adaptive low-concurrency fast path: once
    :data:`DIRECT_AFTER_SINGLETONS` consecutive batches have carried a
    single request each (proof that the delay window coalesces
    nothing), a ``submit()`` that finds nothing in flight and an empty
    queue skips queue + worker + future handoff entirely and runs the
    forward INLINE on the caller's thread — concurrency 1 pays
    naive-dispatch cost instead of a coalescing window it can never
    benefit from. The first contended submit or multi-request batch
    revokes the mode, and traffic coalesces again until the streak
    re-earns it. Stepped mode forces it off — replay determinism
    requires batch composition to be a pure function of the queue
    contents.

    ``threaded=False`` is stepped mode: no worker thread runs, and the
    owner serves queued requests synchronously via :meth:`run_pending`
    (the deterministic-replay seam).

    Robustness knobs: ``retries`` bounds how many times a TRANSIENT
    forward failure (``transient=True`` on the exception, e.g.
    ``faults.TransientFault``) is retried, with
    ``retry_backoff_ms``-based exponential backoff between attempts;
    ``bisect_on_error`` (default on) splits a persistently failing
    multi-request batch in half and serves each half independently so
    one poisoned request fails alone. ``supervise`` (default on, with
    ``crash_loop_threshold`` / ``crash_loop_window_s``) restarts a
    crashed worker thread and trips degraded reject mode on a crash
    loop. ``clock`` overrides the monotonic clock used for DEADLINE
    math only (the replay harness injects its virtual clock there so
    deadline sheds are deterministic); latency timing always uses the
    real clock.
    """

    def __init__(
        self,
        executor: Any,
        *,
        max_delay_ms: float = 2.0,
        max_batch_rows: int = 2048,
        max_queue: int = 256,
        idle_flush_ms: float = 0.25,
        threaded: bool = True,
        direct_dispatch: bool | None = None,
        retries: int = 0,
        retry_backoff_ms: float = 5.0,
        bisect_on_error: bool = True,
        supervise: bool = True,
        crash_loop_threshold: int = 3,
        crash_loop_window_s: float = 30.0,
        clock: Callable[[], float] | None = None,
    ):
        if max_delay_ms < 0 or idle_flush_ms < 0:
            raise ValueError(
                f"delays must be >= 0, got max_delay_ms={max_delay_ms}, "
                f"idle_flush_ms={idle_flush_ms}"
            )
        if max_batch_rows < 1 or max_queue < 1:
            raise ValueError("max_batch_rows and max_queue must be >= 1")
        if retries < 0 or retry_backoff_ms < 0:
            raise ValueError(
                f"retries and retry_backoff_ms must be >= 0, got "
                f"{retries}, {retry_backoff_ms}"
            )
        if crash_loop_threshold < 1 or crash_loop_window_s <= 0:
            raise ValueError(
                "need crash_loop_threshold >= 1 and "
                "crash_loop_window_s > 0"
            )
        if callable(executor) and not hasattr(executor, "forward"):
            self._resolve: Callable[[], Any] = executor
        else:
            self._resolve = lambda: executor
        # contract snapshot: the registry's swap validation guarantees
        # task and feature width are invariant per entry, so submit()
        # validates against this snapshot instead of resolving the
        # executor (a registry-lock acquisition) on every request
        ex0 = self._resolve()
        self._n_features = int(ex0.n_features)
        self._task = ex0.task
        # bucket-ladder snapshot for the arrival-stream events: swap
        # validation keeps task/width invariant per entry, and bucket
        # bounds are registry-sticky options, so capture-time bucket
        # attribution from this snapshot stays honest across swaps
        # (plain callables without a ladder record bucket=None)
        if hasattr(ex0, "min_bucket_rows") and hasattr(
                ex0, "max_batch_rows"):
            self._bucket_bounds = (int(ex0.min_bucket_rows),
                                   int(ex0.max_batch_rows))
        else:
            self._bucket_bounds = None
        if direct_dispatch is None:
            direct_dispatch = threaded
        elif direct_dispatch and not threaded:
            raise ValueError(
                "direct_dispatch requires threaded=True; stepped mode "
                "is the deterministic-replay seam and must keep batch "
                "composition a pure function of the queue"
            )
        self._direct = bool(direct_dispatch)
        # adaptive-dispatch state, all guarded by a dedicated lock held
        # for the counter ops only. Direct mode is EARNED, not assumed:
        # a batcher starts coalescing and demotes to inline serving
        # only after DIRECT_AFTER_SINGLETONS consecutive one-request
        # batches prove there is nobody to coalesce with. (Occupancy
        # alone cannot see a single-threaded async dispatcher that
        # wants 16 futures in flight — inline serving would serialize
        # it — but such a dispatcher produces multi-request batches,
        # which is exactly the signal that keeps coalescing on.)
        self._occupancy = 0
        self._mode_direct = False
        self._singleton_streak = 0
        self._occ_lock = make_lock("serving.batcher.occupancy")
        self.max_delay_s = max_delay_ms / 1e3
        self.idle_flush_s = idle_flush_ms / 1e3
        self.max_batch_rows = int(max_batch_rows)
        self._retries = int(retries)
        self._retry_backoff_s = retry_backoff_ms / 1e3
        self._bisect = bool(bisect_on_error)
        # deadline clock: injectable so the replay harness can drive
        # expiry off its virtual clock (determinism); everything else
        # (latency, stall age) stays on the real monotonic clock
        self._clock: Callable[[], float] = clock or time.monotonic
        self._q: Queue = Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        self._closed = False
        self._close_lock = make_lock("serving.batcher.close")
        # worker supervision state, guarded by its own short lock: the
        # crash history ring sizes itself to the loop threshold, and
        # _degraded is the reject-mode flag submit() reads unlocked
        # (benign: a momentarily stale read sheds or admits one request
        # at the mode boundary)
        self._threaded = bool(threaded)
        self._supervise = bool(supervise) and threaded
        self._crash_window_s = float(crash_loop_window_s)
        self._crash_ts: deque[float] = deque(maxlen=int(crash_loop_threshold))
        self._degraded = False
        self._sup_lock = make_lock("serving.batcher.supervisor")
        # health facts for /healthz: single-writer fields (the worker
        # thread); readers tolerate a momentarily stale float. Seeded
        # at construction so a cold-start burst (queue pinned while
        # the first forward compiles) gets the full STALL_S grace
        # before /healthz calls it a stall
        self._t_last_batch: float = time.monotonic()
        self._worker: threading.Thread | None = None
        if threaded:
            self._worker = threading.Thread(
                target=self._worker_main, daemon=True,
                name="serving-batcher"
            )
            self._worker.start()

    # -- client side ---------------------------------------------------

    # sbt-lint: hot-path
    def submit(self, X, *, mode: str = "aggregate",
               deadline_ms: float | None = None,
               trace: "tracing.TraceContext | None" = None) -> Future:
        """Enqueue one request; returns a ``concurrent.futures.Future``.

        ``mode="aggregate"`` resolves to the executor's raw aggregated
        output (probabilities / predictions); ``mode="predict"``
        resolves to class labels (classification) or predictions
        (regression). ``deadline_ms`` bounds how long the request may
        WAIT: if it is still queued when its batch is claimed past the
        deadline, its future fails with :class:`DeadlineExceeded`
        instead of being served late. Raises :class:`Overloaded` when
        the queue is full, :class:`Degraded` in crash-loop reject
        mode, and ``RuntimeError`` after :meth:`close`. ``trace``
        threads an upstream-minted :class:`~..telemetry.tracing.
        TraceContext` (the tenancy fleet's, carrying pre-batcher
        journey timings) through instead of minting a fresh one here
        — one request, one trace, across every pipeline stage.

        With direct dispatch enabled (the threaded-mode default), an
        idle batcher serves the request INLINE before returning — the
        future comes back already resolved, and concurrent arrivals
        during the inline serve take the coalescing queue.
        """
        if mode not in ("aggregate", "predict"):
            raise ValueError(f"unknown mode {mode!r}")
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        if self._degraded:
            # crash-loop reject mode: shed at the edge, distinctly —
            # a load balancer reading /healthz routes away; anything
            # that still lands here must not hang on a dead worker
            telemetry.inc("sbt_serving_shed_total",
                          labels={"reason": "degraded"})
            telemetry.emit_event({
                "kind": "serving_degraded_reject",
                "rows": int(np.asarray(X).shape[0]) if hasattr(
                    X, "shape") else None,
            })
            raise Degraded(
                "serving is in degraded reject mode (worker crash "
                "loop); call revive() after remediation"
            )
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != self._n_features:
            raise ValueError(
                f"X must be (n, {self._n_features}), got {X.shape}"
            )
        if X.shape[0] == 0:
            raise ValueError("X has no rows")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}"
            )
        if trace is None:
            trace = (tracing.request_context() if telemetry.enabled()
                     else None)
        deadline_t = (self._clock() + deadline_ms / 1e3
                      if deadline_ms is not None else None)
        req = _Request(X, mode, trace, deadline_t)
        if faults.ACTIVE is not None and faults.fire(
                "batcher.submit", rows=req.n):
            # an armed chaos plan marked this request poisoned: its
            # batch's forward fails until bisection isolates it
            req.poisoned = True
        if self._direct:
            # adaptive path decision: serve inline iff direct mode has
            # been earned AND nothing else is in flight — one short
            # lock for the counter ops only. A contended submit while
            # in direct mode is the concurrency signal: revoke the
            # mode on the spot and let the coalescer take over.
            with self._occ_lock:
                direct = (self._mode_direct and self._occupancy == 0
                          and self._q.empty())
                if direct:
                    self._occupancy += 1
                elif self._mode_direct:
                    self._mode_direct = False
                    self._singleton_streak = 0
            if direct:
                return self._serve_direct(req)
        with tracing.use(trace):
            with telemetry.span("serving_enqueue", rows=req.n):
                try:
                    self._q.put_nowait(req)
                except Full:
                    telemetry.inc("sbt_serving_overloaded_total")
                    telemetry.inc("sbt_serving_shed_total",
                                  labels={"reason": "overload"})
                    telemetry.emit_event({
                        "kind": "serving_overloaded",
                        "trace_id": trace.trace_id if trace else None,
                        "rows": req.n,
                        "max_queue": self._q.maxsize,
                    })
                    raise Overloaded(
                        f"serving queue full ({self._q.maxsize} requests "
                        "waiting); retry with backoff or raise max_queue"
                    ) from None
        if self._closed and req.future.cancel():
            # raced close(): its drain may already have run, so nobody
            # would ever serve this request — a successful cancel means
            # no worker claimed it (claims flip it to RUNNING, where
            # cancel() returns False and the request is served anyway);
            # fail fast instead of hanging the caller
            raise RuntimeError("MicroBatcher closed during submit")
        if self._degraded and req.future.cancel():
            # raced the crash-loop trip (same pattern as close above):
            # the degraded drain is one-shot and may already have run,
            # and no worker will ever claim this request — shed it now
            # instead of stranding the caller on a dead worker
            telemetry.inc("sbt_serving_shed_total",
                          labels={"reason": "degraded"})
            raise Degraded(
                "serving entered degraded reject mode during submit"
            )
        if telemetry.enabled():
            telemetry.inc("sbt_serving_requests_total")
            telemetry.set_gauge("sbt_serving_queue_depth",
                                self._q.qsize())
            if telemetry.arrival_events_wanted():
                # the capturable arrival stream (workload recorders,
                # open capture files): dict built only when a consumer
                # is listening — an always-armed flight recorder alone
                # (the standard serving deployment) costs nothing here
                bucket = None
                if self._bucket_bounds is not None:
                    bucket = bucket_for(req.n, *self._bucket_bounds)
                telemetry.emit_event({
                    "kind": "serving_request",
                    "rows": req.n,
                    "width": self._n_features,
                    "dtype": str(req.X.dtype),
                    "bucket": bucket,
                    "queue_depth": self._q.qsize(),
                    "trace_id": trace.trace_id if trace else None,
                    "t_mono": time.monotonic(),
                })
        return req.future

    def predict(self, X, timeout: float | None = 30.0) -> np.ndarray:
        """Synchronous convenience: submit + wait for class labels /
        predictions."""
        return self.submit(X, mode="predict").result(timeout)

    def predict_proba(self, X, timeout: float | None = 30.0) -> np.ndarray:
        """Synchronous convenience: submit + wait for probabilities
        (classification executors only)."""
        if self._task != "classification":
            raise AttributeError(
                "predict_proba is classification-only; this batcher "
                "serves a regression executor"
            )
        return self.submit(X, mode="aggregate").result(timeout)

    def _serve_direct(self, req: _Request) -> Future:
        """The idle fast path: run the forward on the caller's thread,
        bypassing queue, worker, and future handoff. The occupancy slot
        was claimed by :meth:`submit`; released here in ``finally`` so
        a failed forward re-opens the path."""
        try:
            if not req.future.set_running_or_notify_cancel():
                return req.future
            t_claim = time.perf_counter()
            if telemetry.enabled():
                telemetry.inc_many((
                    ("sbt_serving_requests_total", 1.0),
                    ("sbt_serving_direct_dispatch_total", 1.0),
                ))
                if telemetry.arrival_events_wanted():
                    # the capturable arrival stream sees direct serves
                    # too — a replay replays them through the stepped
                    # coalescer, which is exactly the virtual-mode
                    # contract (composition is queue-order, not path)
                    bucket = None
                    if self._bucket_bounds is not None:
                        bucket = bucket_for(req.n, *self._bucket_bounds)
                    telemetry.emit_event({
                        "kind": "serving_request",
                        "rows": req.n,
                        "width": self._n_features,
                        "dtype": str(req.X.dtype),
                        "bucket": bucket,
                        "queue_depth": 0,
                        "trace_id": (req.trace.trace_id if req.trace
                                     else None),
                        "t_mono": time.monotonic(),
                    })
            ex = None
            t_fwd = 0.0
            try:
                if faults.ACTIVE is not None and req.poisoned:
                    # a poisoned direct serve fails alone by
                    # construction — there is no batch to protect
                    raise faults.PoisonedRequest(
                        "poisoned request (direct dispatch)"
                    )
                ex = self._resolve()
                # the same TRANSIENT-retry contract as the coalesced
                # path (bisect is vacuous for a lone request): direct
                # dispatch is the path that serves most low-concurrency
                # traffic, so `retries=` must apply here too. t_fwd
                # accumulates across attempts — retries are real
                # forward latency
                attempt = 0
                while True:
                    try:
                        if telemetry.sinks_active():
                            # someone is consuming events (open
                            # capture, armed recorder): full span
                            # treatment, trace installed so
                            # serving_direct/serving_forward carry
                            # the ids
                            with tracing.use(req.trace):
                                with telemetry.span("serving_direct",
                                                    rows=req.n):
                                    t0 = time.perf_counter()
                                    try:
                                        out = ex.forward(req.X)
                                    finally:
                                        t_fwd += (time.perf_counter()
                                                  - t0)
                        else:
                            # lean inline serve: metrics still count
                            # (inside the executor), spans are skipped
                            # — span events with no sink are built
                            # only to be dropped, and that build was a
                            # measurable slice of the per-request
                            # budget at concurrency 1
                            t0 = time.perf_counter()
                            try:
                                if hasattr(ex, "_forward_packed"):
                                    # submit() already validated: skip
                                    # the executor's re-validation pass
                                    (out,) = ex._forward_packed([req.X])
                                else:
                                    out = ex.forward(req.X)
                            finally:
                                t_fwd += time.perf_counter() - t0
                        break
                    except BaseException as e:  # noqa: BLE001 — retry ladder
                        if getattr(e, "transient", False) \
                                and attempt < self._retries:
                            attempt += 1
                            telemetry.inc("sbt_serving_retries_total")
                            telemetry.emit_event({
                                "kind": "serving_retry",
                                "attempt": attempt,
                                "requests": 1,
                                "error": repr(e),
                            })
                            if self._retry_backoff_s > 0:
                                time.sleep(self._retry_backoff_s
                                           * (2 ** (attempt - 1)))
                            continue
                        raise
                if not telemetry.sinks_active():
                    if req.trace is not None and hasattr(
                            ex, "min_bucket_rows"):
                        # no context was installed, so the executor's
                        # bucket annotations had nowhere to land —
                        # recompute the (deterministic) plan for the
                        # breakdown contract, from the RESOLVED
                        # executor's bounds (a swap may have changed
                        # them since this batcher snapshotted its own)
                        req.trace.annotations["bucket"] = list(
                            pack_plan(req.n, ex.min_bucket_rows,
                                      ex.max_batch_rows)
                        )
            except BaseException as e:  # noqa: BLE001 — delivered via the future
                self._finish_breakdown(
                    req, ex, t_claim, time.perf_counter(), t_fwd,
                    None, 1, error=repr(e), path="direct",
                )
                req.future.set_exception(e)
                telemetry.inc("sbt_serving_request_failures_total")
                telemetry.inc("sbt_serving_batch_errors_total")
                telemetry.emit_event({
                    "kind": "serving_batch_error",
                    "error": repr(e),
                    "requests": 1,
                    "rows": req.n,
                    "path": "direct",
                    "trace_id": (req.trace.trace_id if req.trace
                                 else None),
                    # same resolvability contract as the batch-path
                    # event: flight dumps index incidents by links
                    "links": ([req.trace.trace_id] if req.trace
                              else []),
                })
                return req.future
            t_done = time.perf_counter()
            piece = out
            try:
                if req.mode == "predict" and ex.task == "classification":
                    piece = ex.classes_[piece.argmax(axis=1)]
                self._finish_breakdown(req, ex, t_claim, t_done, t_fwd,
                                       None, 1, path="direct")
                req.future.set_result(piece)
            except BaseException as e:  # noqa: BLE001
                if not req.future.done():
                    req.future.set_exception(e)
            if telemetry.enabled():
                lat = t_done - req.t_submit
                telemetry.observe(
                    "sbt_serving_latency_seconds", lat,
                    exemplar=(req.trace.trace_id if req.trace else None),
                )
                telemetry.observe("sbt_serving_latency_seconds", lat,
                                  labels={"path": "direct"})
            return req.future
        finally:
            with self._occ_lock:
                self._occupancy -= 1
                # last-batch stamp doubles as the direct path's
                # liveness heartbeat for /healthz staleness math
                self._t_last_batch = time.monotonic()

    # -- observability -------------------------------------------------

    # a full queue that has not drained a batch for this long means
    # traffic is arriving but nothing is served (hung device forward);
    # an empty queue with an old last-batch age is just an idle process
    STALL_S = 10.0

    def health(self) -> dict:
        """Liveness facts for ``/healthz`` (registered automatically):
        healthy means SERVING traffic — closed, dead-worker (a crash
        the supervisor could not absorb), degraded (crash-loop reject
        mode), and stalled (queue pinned at its bound past
        :data:`STALL_S` with no batch completing) batchers all report
        unhealthy so a load balancer stops routing here."""
        depth = self._q.qsize()
        with self._sup_lock:
            worker = self._worker
            degraded = self._degraded
            crashes = len(self._crash_ts)
        # stepped mode has no worker by design: liveness there is just
        # "not closed" (the owner serves on its own thread)
        alive = (worker.is_alive() if worker is not None
                 else not self._closed)
        age = time.monotonic() - self._t_last_batch
        stalled = depth >= self._q.maxsize and age > self.STALL_S
        return {
            "healthy": (not self._closed and alive and not stalled
                        and not degraded),
            "closed": self._closed,
            "worker_alive": alive,
            "degraded": degraded,
            "crashes_in_window": crashes,
            "stalled": stalled,
            "queue_depth": depth,
            "max_queue": self._q.maxsize,
            "last_batch_age_s": age,
        }

    def stats(self) -> dict:
        """Serving stats off the live registry: cumulative counters
        (including the direct-vs-coalesced dispatch split) plus
        request-latency quantiles (p50/p95/p99, log-bucket
        interpolation — the same numbers ``/varz`` serves)."""
        reg = telemetry.registry()
        return {
            "requests": reg.counter("sbt_serving_requests_total").value,
            "batches": reg.counter("sbt_serving_batches_total").value,
            "direct": reg.counter(
                "sbt_serving_direct_dispatch_total").value,
            "coalesced": reg.counter("sbt_serving_coalesced_total").value,
            "overloaded": reg.counter("sbt_serving_overloaded_total").value,
            "batch_errors": reg.counter(
                "sbt_serving_batch_errors_total").value,
            "retries": reg.counter("sbt_serving_retries_total").value,
            "shed": {
                reason: reg.counter("sbt_serving_shed_total",
                                    labels={"reason": reason}).value
                for reason in ("overload", "deadline", "degraded")
            },
            "worker_crashes": reg.counter(
                "sbt_serving_worker_crashes_total").value,
            "latency": reg.histogram(
                "sbt_serving_latency_seconds").quantiles(),
            "latency_direct": reg.histogram(
                "sbt_serving_latency_seconds",
                labels={"path": "direct"}).quantiles(),
            "latency_coalesced": reg.histogram(
                "sbt_serving_latency_seconds",
                labels={"path": "coalesced"}).quantiles(),
            **self.health(),
        }

    # -- lifecycle -----------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting requests, let the in-flight batch finish,
        fail whatever is still queued, join the worker."""
        # the flag flip is a check-then-act: two racing close() calls
        # must not BOTH run the drain loop below (found by the
        # shared-state-unlocked lint rule when this class was marked)
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # stop BEFORE the join: the worker's outer get() polls the flag
        # every 100ms, so even with a full queue (sentinel un-enqueueable)
        # it exits after at most the in-flight batch + one poll — the
        # join never has to burn its whole timeout on a set-too-late flag
        self._stop.set()
        try:  # best-effort wake so an idle worker exits immediately
            self._q.put_nowait(_SHUTDOWN)
        except Full:
            pass
        with self._sup_lock:
            # the supervisor may have replaced the worker thread since
            # construction: join the CURRENT one
            worker = self._worker
        if worker is not None:
            worker.join(timeout)
        # anything still queued was never forwarded — fail it loudly
        while True:
            try:
                req = self._q.get_nowait()
            except Empty:
                break
            if req is _SHUTDOWN:
                continue
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(
                    RuntimeError("MicroBatcher closed before this "
                                 "request was served")
                )

    def retire(self) -> None:
        """Close for good. The JAX package's ``retire`` also leaves the
        exposition server's ``/healthz`` set, which is not ported, so
        here it is :meth:`close`."""
        self.close()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- stepped mode (deterministic replay) ---------------------------

    def run_pending(self, max_batches: int | None = None) -> int:
        """Serve everything queued, synchronously, on THIS thread.

        Stepped-mode (``threaded=False``) counterpart of the worker
        loop: drains the queue into batches by the same row rule
        (gather until ``max_batch_rows``; one request may overshoot,
        exactly like the worker) and runs each through
        :meth:`_run_batch` — real padding, real tracing, real
        telemetry. What it deliberately does NOT have is the worker's
        clock: batch composition is a pure function of the submission
        order, which is what makes ``same capture + same seed ⇒
        identical batches, bitwise-identical outputs`` a contract the
        replay harness can assert rather than hope for. Returns the
        number of batches served.
        """
        if self._worker is not None:
            raise RuntimeError(
                "run_pending() is stepped-mode only; this batcher "
                "runs a worker thread (construct with threaded=False)"
            )
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        ran = 0
        while max_batches is None or ran < max_batches:
            batch: list = []
            rows = 0
            while rows < self.max_batch_rows:
                try:
                    req = self._q.get_nowait()
                except Empty:
                    break
                if req is _SHUTDOWN:
                    continue
                batch.append(req)
                rows += req.n
            if not batch:
                break
            self._run_batch(batch)
            ran += 1
        return ran

    # -- worker side ---------------------------------------------------

    def _worker_main(self) -> None:
        """Thread target: the coalescing loop under supervision. A
        crash that escapes the per-batch guard lands in
        :meth:`_on_worker_crash` instead of silently killing serving."""
        try:
            self._loop()
        # sbt-lint: disable=swallowed-fault — the fault IS the payload: the supervisor counts, flight-records, and restarts/degrades on it
        except BaseException as e:  # noqa: BLE001 — the supervision seam
            self._on_worker_crash(e)

    def _on_worker_crash(self, e: BaseException) -> None:
        """Supervisor: count + record the crash, then either restart a
        fresh worker or — on a crash loop — trip degraded reject mode
        (one flight dump, /healthz 503, queue drained with
        :class:`Degraded`)."""
        telemetry.inc("sbt_serving_worker_crashes_total")
        telemetry.emit_event({
            "kind": "serving_worker_crash", "error": repr(e),
        })
        restart = False
        with self._sup_lock:
            now = time.monotonic()
            self._crash_ts.append(now)
            looping = (
                len(self._crash_ts) == self._crash_ts.maxlen
                and now - self._crash_ts[0] <= self._crash_window_s
            )
            if self._closed or not self._supervise:
                return
            if looping:
                self._degraded = True
            else:
                restart = True
        if not restart:
            telemetry.inc("sbt_serving_crash_loops_total")
            # serving_crash_loop is a flight-recorder TRIGGER: exactly
            # one dump for the incident (per-kind cooldown), with the
            # crash events of the loop in its ring
            telemetry.emit_event({
                "kind": "serving_crash_loop",
                "crashes": len(self._crash_ts),
                "window_s": self._crash_window_s,
                "error": repr(e),
            })
            self._fail_queued(Degraded(
                "batcher entered degraded reject mode (worker crash "
                "loop)"
            ), reason="degraded")
            return
        telemetry.inc("sbt_serving_worker_restarts_total")
        t = threading.Thread(target=self._worker_main, daemon=True,
                             name="serving-batcher")
        with self._sup_lock:
            # started BEFORE it is published: a close() that reads
            # self._worker must never join a thread not yet started
            t.start()
            self._worker = t

    def _fail_queued(self, exc: BaseException, reason: str) -> None:
        """Drain the queue, failing every still-pending request with
        ``exc`` (counted as shed under ``reason``) — degraded mode
        must reject, not strand."""
        while True:
            try:
                req = self._q.get_nowait()
            except Empty:
                return
            if req is _SHUTDOWN:
                continue
            if req.future.set_running_or_notify_cancel():
                telemetry.inc("sbt_serving_shed_total",
                              labels={"reason": reason})
                req.future.set_exception(exc)

    def revive(self) -> None:
        """Operator reset out of degraded reject mode: clear the crash
        history and start a fresh worker. A no-op on a healthy
        threaded batcher; raises after :meth:`close`."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        t: threading.Thread | None = None
        with self._sup_lock:
            self._degraded = False
            self._crash_ts.clear()
            alive = self._worker is not None and self._worker.is_alive()
            if not alive and self._threaded:
                t = threading.Thread(target=self._worker_main,
                                     daemon=True,
                                     name="serving-batcher")
                # started before it is published (see _on_worker_crash)
                t.start()
                self._worker = t
        if t is not None:
            telemetry.inc("sbt_serving_worker_restarts_total")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except Empty:
                continue
            if first is _SHUTDOWN:
                return
            if faults.ACTIVE is not None:
                # worker-crash drills: the probe sits AFTER a request
                # is claimed (deterministic per-claim hit counts); its
                # future is failed before the crash propagates so no
                # caller hangs on a request the dying worker took
                try:
                    faults.fire("batcher.worker")
                except BaseException:
                    if first.future.set_running_or_notify_cancel():
                        first.future.set_exception(RuntimeError(
                            "serving worker crashed (injected fault)"
                        ))
                    raise
            batch = [first]
            rows = first.n
            deadline = time.perf_counter() + self.max_delay_s
            while rows < self.max_batch_rows:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    # linger at most idle_flush on an empty queue: an
                    # Empty here means the wave is absorbed — launch
                    # now instead of sleeping out the window
                    req = self._q.get(
                        timeout=min(remaining, self.idle_flush_s)
                    )
                except Empty:
                    break
                if req is _SHUTDOWN:
                    self._stop.set()
                    break
                batch.append(req)
                rows += req.n
            self._run_batch(batch)

    #: consecutive one-request coalesced batches before the adaptive
    #: dispatcher concludes there is nobody to coalesce with and
    #: serves submits inline (direct mode); any multi-request batch or
    #: contended submit resets the streak and the mode
    DIRECT_AFTER_SINGLETONS = 8

    def _run_batch(self, batch: list) -> None:
        # in-queue deadline expiry happens at claim time, BEFORE the
        # futures are claimed for serving: an expired request is shed
        # as DeadlineExceeded (reason="deadline"), never served late
        # and never billed as Overloaded
        if any(r.deadline_t is not None for r in batch):
            batch = self._expire_deadlines(batch)
        # claim the futures; drop requests cancelled while queued
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not live:
            return
        if self._direct:
            # the adaptive-dispatch evidence loop: singleton batches
            # mean the delay window buys nothing — after a streak of
            # them, demote to inline serving; one coalesced batch
            # proves concurrency and revokes it. The batch also HOLDS
            # an occupancy slot while it forwards (released in
            # _release_slot): without it, a submit landing while
            # the worker is mid-forward on an empty queue would see
            # "nothing in flight" and serve inline CONCURRENTLY with
            # the worker — and direct mode could survive real
            # concurrency-2 traffic because the revocation signal
            # (occupancy > 0) never fired
            with self._occ_lock:
                self._occupancy += 1
                if len(live) == 1:
                    self._singleton_streak += 1
                    if (self._singleton_streak
                            >= self.DIRECT_AFTER_SINGLETONS):
                        self._mode_direct = True
                else:
                    self._singleton_streak = 0
                    self._mode_direct = False
            token = [True]
        else:
            token = []
        try:
            self._run_batch_held(live, token)
        except BaseException as e:  # noqa: BLE001 — deliver, then crash
            # a crash that escaped even _run_batch_held's guards (a
            # sink dying in the scatter span, an injected fault): the
            # futures this batch CLAIMED must fail before the crash
            # reaches the supervisor — a restarted worker never
            # revisits them, and a stranded claimed future blocks its
            # caller forever with /healthz reporting healthy
            for r in live:
                if not r.future.done():
                    r.future.set_exception(RuntimeError(
                        f"serving worker crashed mid-batch: {e!r}"
                    ))
            raise
        finally:
            self._release_slot(token)  # backstop; normally a no-op

    def _release_slot(self, token: list) -> None:
        """Release a batch's occupancy slot exactly once. Called right
        after the FORWARD completes — before futures resolve — because
        a closed-loop client wakes on its future and submits again
        immediately: if the slot outlived the scatter, that submit
        would read occupancy 1 and revoke direct mode the moment it
        was earned. The slot's job is only to cover the device
        forward (no inline serve may run concurrently with it)."""
        if token:
            token.clear()
            with self._occ_lock:
                self._occupancy -= 1

    def _expire_deadlines(self, batch: list) -> list:
        """Shed every claimed request whose deadline already passed on
        the batcher's clock; returns the survivors."""
        now = self._clock()
        kept: list = []
        for r in batch:
            if r.deadline_t is None or now <= r.deadline_t:
                kept.append(r)
                continue
            if not r.future.set_running_or_notify_cancel():
                continue  # cancelled while queued: nothing to shed
            telemetry.inc("sbt_serving_shed_total",
                          labels={"reason": "deadline"})
            telemetry.emit_event({
                "kind": "serving_deadline_exceeded",
                "rows": r.n,
                "late_s": now - r.deadline_t,
                "trace_id": (r.trace.trace_id if r.trace else None),
            })
            if r.trace is not None:
                r.trace.breakdown.update({
                    "error": "DeadlineExceeded", "path": "shed",
                })
            r.future.set_exception(DeadlineExceeded(
                "request expired in queue (deadline passed by "
                f"{(now - r.deadline_t) * 1e3:.1f} ms)"
            ))
        return kept

    def _forward_once(self, ex: Any, reqs: list) -> list:
        """ONE forward attempt over ``reqs``; returns one output per
        request. The chaos probe and the poison check sit here, so
        retries and bisection re-drive them deterministically."""
        if faults.ACTIVE is not None:
            faults.fire("batcher.batch_forward", requests=len(reqs))
            if any(r.poisoned for r in reqs):
                raise faults.PoisonedRequest(
                    f"poisoned request in batch of {len(reqs)}"
                )
        rows = sum(r.n for r in reqs)
        with telemetry.span("serving_batch", rows=rows,
                            requests=len(reqs)):
            if hasattr(ex, "forward_parts"):
                # ragged packing: request blocks scatter straight into
                # the pack plan's slabs (one copy per row, minimal
                # padding) and come back pre-split per request
                return list(ex.forward_parts([r.X for r in reqs]))
            # plain-callable executors (no ragged seam): concatenate
            # and slice, as ever
            X = (reqs[0].X if len(reqs) == 1
                 else np.concatenate([r.X for r in reqs]))
            out = ex.forward(X)
            outs = []
            off = 0
            for r in reqs:
                outs.append(out[off:off + r.n])
                off += r.n
            return outs

    def _serve_requests(self, ex: Any, reqs: list) -> list:
        """Serve ``reqs`` with the recovery ladder: bounded retry with
        exponential backoff for TRANSIENT failures, then bisection so
        a poisoned request fails alone. Returns one output per request
        — a :class:`_Failed` sentinel where that request's forward
        ultimately failed (delivered per-future by the scatter)."""
        attempt = 0
        while True:
            try:
                return self._forward_once(ex, reqs)
            except BaseException as e:  # noqa: BLE001 — recovery ladder
                if getattr(e, "transient", False) \
                        and attempt < self._retries:
                    attempt += 1
                    telemetry.inc("sbt_serving_retries_total")
                    telemetry.emit_event({
                        "kind": "serving_retry",
                        "attempt": attempt,
                        "requests": len(reqs),
                        "error": repr(e),
                    })
                    if self._retry_backoff_s > 0:
                        time.sleep(
                            self._retry_backoff_s * (2 ** (attempt - 1))
                        )
                    continue
                if len(reqs) > 1 and self._bisect:
                    # bisect-on-poison: each half serves (and retries)
                    # independently; recursion bottoms out at single
                    # requests, so exactly the bad ones fail
                    telemetry.inc("sbt_serving_batch_bisects_total")
                    mid = (len(reqs) + 1) // 2
                    return (self._serve_requests(ex, reqs[:mid])
                            + self._serve_requests(ex, reqs[mid:]))
                telemetry.inc("sbt_serving_request_failures_total",
                              float(len(reqs)))
                telemetry.inc("sbt_serving_batch_errors_total")
                telemetry.emit_event({
                    "kind": "serving_batch_error",
                    "error": repr(e),
                    "requests": len(reqs),
                    "rows": sum(r.n for r in reqs),
                    "links": [r.trace.trace_id for r in reqs
                              if r.trace is not None],
                })
                return [_Failed(e)] * len(reqs)

    def _run_batch_held(self, live: list, token: list) -> None:
        t_claim = time.perf_counter()
        if telemetry.enabled():
            telemetry.inc("sbt_serving_batches_total")
            telemetry.inc("sbt_serving_coalesced_total",
                          float(len(live)))
            telemetry.set_gauge("sbt_serving_queue_depth",
                                self._q.qsize())
        # one batch-level trace context linked to every member request:
        # the coalesced batch/forward/scatter spans resolve from any of
        # the trace ids riding the batch
        traced = [r.trace for r in live if r.trace is not None]
        bctx = tracing.batch_context(traced) if traced else None
        ex = None
        t_fwd = 0.0
        try:
            ex = self._resolve()
            with tracing.use(bctx):
                t0 = time.perf_counter()
                try:
                    # recovery lives INSIDE the timed window: retries
                    # and bisection are real forward latency the
                    # breakdown must attribute honestly
                    outs = self._serve_requests(ex, live)
                finally:
                    t_fwd = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — delivered per-future
            # catastrophic path (executor resolution failed, or
            # recovery itself died): release BEFORE delivering — a
            # client waking on the exception may submit immediately
            self._release_slot(token)
            t_fail = time.perf_counter()
            for r in live:
                self._finish_breakdown(
                    r, ex, t_claim, t_fail, t_fwd, bctx, len(live),
                    error=repr(e),
                )
                r.future.set_exception(e)
            telemetry.inc("sbt_serving_batch_errors_total")
            telemetry.emit_event({
                "kind": "serving_batch_error",
                "error": repr(e),
                "requests": len(live),
                "rows": sum(r.n for r in live),
                "trace_id": bctx.trace_id if bctx else None,
                "links": [t.trace_id for t in traced],
            })
            return
        # the device forward is done: drop the occupancy slot BEFORE
        # any future resolves (see _release_slot)
        self._release_slot(token)
        # sbt-lint: disable=shared-state-unlocked — last-write-wins monotonic stamp (worker thread + direct finishers); /healthz readers tolerate a stale float
        self._t_last_batch = time.monotonic()
        with tracing.use(bctx):
            with telemetry.span("serving_scatter", requests=len(live)):
                t_done = time.perf_counter()
                for i, r in enumerate(live):
                    piece = outs[i]
                    if isinstance(piece, _Failed):
                        # this request's forward failed after the full
                        # recovery ladder — it fails ALONE; its
                        # batch-mates resolve normally below
                        self._finish_breakdown(
                            r, ex, t_claim, t_done, t_fwd, bctx,
                            len(live), error=repr(piece.error),
                        )
                        r.future.set_exception(piece.error)
                        continue
                    try:
                        if (r.mode == "predict"
                                and ex.task == "classification"):
                            piece = ex.classes_[piece.argmax(axis=1)]
                        self._finish_breakdown(
                            r, ex, t_claim, t_done, t_fwd, bctx,
                            len(live),
                        )
                        r.future.set_result(piece)
                    except BaseException as e:  # noqa: BLE001
                        if not r.future.done():
                            r.future.set_exception(e)
                    if telemetry.enabled():
                        lat = t_done - r.t_submit
                        telemetry.observe(
                            "sbt_serving_latency_seconds", lat,
                            exemplar=(r.trace.trace_id if r.trace
                                      else None),
                        )
                        telemetry.observe(
                            "sbt_serving_latency_seconds", lat,
                            labels={"path": "coalesced"},
                        )

    @staticmethod
    def _finish_breakdown(
        r: _Request, ex: Any, t_claim: float, t_done: float,
        t_fwd: float, bctx: "tracing.TraceContext | None",
        n_requests: int, error: str | None = None,
        path: str = "coalesced",
    ) -> None:
        """Fill the request trace's timing breakdown — complete before
        the future resolves, so `future.result(); future.trace.breakdown`
        never races."""
        if r.trace is None:
            return
        # bucket annotations land on the batch context when one exists
        # (coalesced path); direct serves annotate the request trace
        src = bctx if bctx is not None else r.trace
        buckets = src.annotations.get("bucket", []) if src else []
        bd = {
            "queue_ms": (t_claim - r.t_submit) * 1e3,
            "batch_ms": (t_done - t_claim) * 1e3,
            "forward_ms": t_fwd * 1e3,
            "total_ms": (t_done - r.t_submit) * 1e3,
            "batch_size": n_requests,
            "path": path,
            "bucket": (buckets[0] if len(buckets) == 1
                       else list(buckets) or None),
            "model_name": getattr(ex, "model_name", None),
            "model_version": getattr(ex, "model_version", None),
            "batch_trace_id": bctx.trace_id if bctx else None,
        }
        if error is not None:
            bd["error"] = error
        r.trace.breakdown.update(bd)
