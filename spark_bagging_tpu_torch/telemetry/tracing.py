"""Per-request distributed tracing — identity for the serving path.

A slow served request is unexplainable without attribution: did it sit
in the micro-batcher queue, wait for batch-mates, or pay the device
forward? This module mints the identity that threads the whole path:

- every ``MicroBatcher.submit()`` creates a :class:`TraceContext` — a
  ``trace_id`` (one request's journey) plus a human-pasteable
  ``request_id`` — exposed on the returned future as ``future.trace``;
- spans opened while a context is *installed* on the thread
  (:func:`use`) carry ``trace_id``/``span_id``/``parent_id`` in their
  event dicts, so the JSONL log and the ``/debug/spans`` ring become a
  queryable span tree;
- the batcher worker installs a **batch context** whose ``links`` list
  the member requests' trace ids: the coalesced ``serving_batch`` /
  ``serving_forward`` / ``serving_scatter`` spans belong to one batch
  but are resolvable from every request riding it (the one-to-many
  fan-in that makes micro-batched tracing different from RPC tracing);
- :func:`annotate` lets deep layers (the executor's bucket choice)
  attach facts to whatever context is current without plumbing
  arguments through every call signature.

Cost contract: when telemetry is disabled no context is ever minted
(``future.trace is None``); when no context is installed the span-path
hook is one thread-local attribute read. Ids are a random process
prefix + atomic counter, not per-call ``os.urandom`` — the getrandom
syscall costs microseconds on older kernels, and id minting sits on
the submit path of every request across every client thread.
"""

from __future__ import annotations

import itertools
import os
import threading
from contextlib import contextmanager, nullcontext
from typing import Any, ContextManager, Iterator

# one syscall at import; uniqueness within the process comes from the
# counter (itertools.count.__next__ is atomic under the GIL), across
# processes from the 8-hex random prefix
_ID_PREFIX = os.urandom(4).hex()
_id_counter = itertools.count(1)


def _reseed_ids() -> None:
    # a fork()ed child inherits both prefix and counter and would mint
    # byte-identical ids to its siblings — re-seed in the child so the
    # cross-process-uniqueness contract survives multiprocessing(fork)
    global _ID_PREFIX, _id_counter
    _ID_PREFIX = os.urandom(4).hex()
    _id_counter = itertools.count(1)


if hasattr(os, "register_at_fork"):  # POSIX only; no fork elsewhere
    os.register_at_fork(after_in_child=_reseed_ids)


def _new_id() -> str:
    return f"{_ID_PREFIX}{next(_id_counter):08x}"


class TraceContext:
    """One traced unit of work: a request, or the batch serving many.

    ``breakdown`` is filled by the batcher as the request moves
    through the pipeline (``queue_ms``, ``batch_ms``, ``forward_ms``,
    ``total_ms``, ``batch_size``, ``bucket``, ``model_version``,
    ``error``) and is complete by the time the request's future
    resolves. ``annotations`` collects facts attached via
    :func:`annotate` while the context is installed (each key holds
    the LIST of values seen — a slab-split forward annotates
    ``bucket`` once per slab). ``links`` (batch contexts only) are the
    trace ids of the member requests.
    """

    __slots__ = (
        "trace_id", "request_id", "links", "annotations",
        "breakdown", "journey", "_span_stack",
    )

    def __init__(
        self,
        *,
        trace_id: str | None = None,
        request_id: str | None = None,
        links: tuple[str, ...] = (),
    ) -> None:
        self.trace_id = trace_id or _new_id()
        self.request_id = request_id
        self.links = tuple(links)
        self.annotations: dict[str, list] = {}
        self.breakdown: dict[str, Any] = {}
        # pre-batcher journey stage timings (``admission_ms``,
        # ``wfq_ms``, ``restore_ms``, ``dispatch_ms`` + ``tenant``),
        # stamped by the tenancy fleet; None for traces minted by the
        # batcher itself — the breakdown fix-up gates on this so a
        # single-model process pays one attribute read, nothing more
        self.journey: dict[str, Any] | None = None
        # span ids open on THIS context, innermost last; only the
        # installing thread touches it (contexts are installed on one
        # thread at a time — the submit thread, then the worker)
        self._span_stack: list[str] = []

    # -- span linkage (called by telemetry.spans) ----------------------

    def begin_span(self) -> dict[str, Any]:
        """Mint a span id nested under the current one; returns the
        identity fields the span event should carry."""
        parent = self._span_stack[-1] if self._span_stack else None
        span_id = _new_id()
        self._span_stack.append(span_id)
        fields: dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": span_id,
        }
        if parent is not None:
            fields["parent_id"] = parent
        if self.request_id is not None:
            fields["request_id"] = self.request_id
        if self.links:
            fields["links"] = list(self.links)
        return fields

    def end_span(self) -> None:
        if self._span_stack:
            self._span_stack.pop()

    def __repr__(self) -> str:  # debugger/REPL affordance
        rid = f", request_id={self.request_id!r}" if self.request_id else ""
        return f"TraceContext(trace_id={self.trace_id!r}{rid})"


def request_context() -> TraceContext:
    """A fresh per-request context (trace id + request id)."""
    return TraceContext(request_id=f"req-{_new_id()}")


def batch_context(members: list["TraceContext"]) -> TraceContext:
    """A context for one coalesced micro-batch, linked to every member
    request's trace so batch-level spans resolve from any of them."""
    return TraceContext(links=tuple(m.trace_id for m in members))


class _Current(threading.local):
    ctx: "TraceContext | None" = None


_current = _Current()


def current() -> TraceContext | None:
    """The context installed on this thread, or None."""
    return _current.ctx


# reusable + reentrant: one shared null manager serves every
# disabled-mode `with tracing.use(None)` without a per-request
# generator allocation (the cost-contract analog of telemetry.span's
# cached no-op singleton)
_NULL_CM: ContextManager[None] = nullcontext()


@contextmanager
def _install(ctx: TraceContext) -> Iterator[TraceContext]:
    prev = _current.ctx
    _current.ctx = ctx
    try:
        yield ctx
    finally:
        _current.ctx = prev


def use(ctx: TraceContext | None) -> ContextManager[TraceContext | None]:
    """Install ``ctx`` as this thread's current trace context for the
    block. ``use(None)`` is a no-op passthrough returning a shared
    null manager — zero allocation, so the disabled path keeps one
    code shape at the call sites without paying for it."""
    if ctx is None:
        return _NULL_CM
    return _install(ctx)


def annotate(**facts: Any) -> None:
    """Attach facts to the current context (no-op when none is
    installed). Each key accumulates a list — call sites that run more
    than once per context (slab-split forwards) append rather than
    overwrite."""
    ctx = _current.ctx
    if ctx is None:
        return
    for k, v in facts.items():
        ctx.annotations.setdefault(k, []).append(v)
