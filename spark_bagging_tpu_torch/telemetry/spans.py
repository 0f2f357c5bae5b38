"""Nestable phase spans — the host-side half of the tracing story.

``span("serving_forward")`` records wall-clock for a phase into the
current run's event stream and maintains a per-thread nesting stack
(so events carry a full ``path`` like ``serving_batch/serving_forward``).
``phase()`` composes it with ``torch.profiler.record_function``, so
host spans and ``torch.profiler`` traces (``profile_fit.py``) segment
by the SAME phase names. When a request trace context is
installed on the thread (``telemetry.tracing``), every span event
additionally carries ``trace_id``/``span_id``/``parent_id`` (and, for
batch-level contexts, ``links`` to member request traces), turning the
event stream into a queryable per-request span tree.

Two cost tiers, per the zero-overhead-when-disabled contract:

- disabled: ``span()`` returns a shared no-op context manager (or a
  bare ``record_function`` from ``phase()``, preserving the profiler
  annotation) — no clock reads, no allocation.
- enabled: two ``perf_counter`` reads plus an event append; optional
  **device-sync** timing (``set_device_sync(True)``) drains the
  dispatch queue at span exit so the wall-clock covers the device work
  launched inside the span, not just its dispatch — opt-in because the
  barrier serializes the pipeline it is measuring.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

import torch
from torch.profiler import record_function as _record_function

from spark_bagging_tpu_torch.telemetry import tracing
from spark_bagging_tpu_torch.telemetry.state import STATE as _state


class _Nesting(threading.local):
    def __init__(self) -> None:
        self.stack: list[str] = []


_nesting = _Nesting()


def _device_barrier() -> None:
    """Full-queue drain of the current CUDA device (a no-op without
    CUDA: CPU tensors compute eagerly)."""
    from spark_bagging_tpu_torch.analysis import locks

    # a sync span entered while holding an instrumented lock would park
    # every waiter behind the device queue — record the hazard when
    # lock debugging is on (free otherwise: one module-flag read)
    locks.note_device_sync("telemetry span device barrier")
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


@contextmanager
def _record_span(
    name: str, attrs: dict[str, Any] | None, metric: str | None,
    sync: bool | None, profile: bool = True,
) -> Iterator[None]:
    stack = _nesting.stack
    do_sync = _state.device_sync if sync is None else sync
    if do_sync:
        # entry barrier BEFORE the stack push: if the device is already
        # wedged this raises without corrupting the nesting state
        _device_barrier()
    stack.append(name)
    path = "/".join(stack)
    tctx = tracing.current()
    trace_fields = tctx.begin_span() if tctx is not None else None
    # inside an open torch.profiler session the span is also a profiler
    # range, so profile traces segment by the span names too
    prof = (_record_function(name)
            if profile and torch.autograd.profiler._is_profiler_enabled
            else None)
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    t0_epoch = time.time()
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        # pop FIRST — later spans on this thread must not inherit a
        # stale path prefix no matter what the barrier below does
        stack.pop()
        if tctx is not None:
            tctx.end_span()
        if do_sync:
            try:
                _device_barrier()
            # sbt-lint: disable=swallowed-fault — deliberate: the body's own exception (already propagating) must not be masked by the measurement barrier failing for the same cause
            except Exception:  # noqa: BLE001 — a body exception (the
                # device failing mid-span) must not be masked by the
                # measurement barrier failing for the same reason
                pass
        dt = time.perf_counter() - t0
        if metric is not None:
            _state.registry.observe(metric, dt)
        event = {
            "kind": "span",
            "name": name,
            "path": path,
            "ts": t0_epoch,
            "seconds": dt,
            "sync": bool(do_sync),
        }
        if trace_fields is not None:
            event.update(trace_fields)
        if attrs:
            event["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        _state.emit(event)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def span(
    name: str,
    *,
    metric: str | None = None,
    sync: bool | None = None,
    **attrs: Any,
):
    """Record a nestable host phase span named ``name``.

    ``metric`` additionally folds the duration into that log-scale
    histogram in the registry (e.g. per-chunk latencies). ``sync``
    forces device-sync timing on/off for this span regardless of the
    global opt-in. No-op (one attribute read) when telemetry is
    disabled.
    """
    if not _state.enabled:
        return _NOOP
    return _record_span(name, attrs or None, metric, sync)


def phase(name: str, *, sync: bool | None = None, **attrs: Any):
    """``span()`` fused with ``torch.profiler.record_function``: the
    phase annotates a ``torch.profiler`` trace under the same name the
    host span records, so the two timelines correlate by name. When
    telemetry is disabled this degrades to the bare
    ``record_function`` — the same profiler annotation, zero added host
    work."""
    scope = _record_function(name)
    if not _state.enabled:
        return scope
    return _Both(scope, _record_span(name, attrs or None, None, sync,
                                    profile=False))


class _Both:
    """Enter/exit two context managers as one (scope outer, span inner)."""

    __slots__ = ("_a", "_b")

    def __init__(self, a, b) -> None:
        self._a, self._b = a, b

    def __enter__(self):
        self._a.__enter__()
        try:
            self._b.__enter__()
        except BaseException:
            self._a.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        try:
            self._b.__exit__(*exc)
        finally:
            self._a.__exit__(*exc)
        return None
