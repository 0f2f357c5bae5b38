"""Lock-order race detector — instrumented locks for the threaded path.

The serving path is concurrent: submitter threads, the
batcher worker, swap callers, and telemetry emitters interleave. The
two failure modes that survive unit tests there are (1) lock-order
inversion — thread A takes L1 then L2 while thread B takes L2 then L1,
deadlocking only under the right interleaving — and (2) a device sync
performed while holding a lock, which turns every waiter into a
passenger of the accelerator's queue depth.

Both are ORDER properties, observable from any single-threaded run that
merely exercises the acquisition patterns: the detector records the
per-thread acquisition graph (edge ``a -> b`` whenever ``b`` is taken
while ``a`` is held) and flags cycles the moment the closing edge
appears — no deadlock needs to actually happen.

Zero-cost by default: :func:`make_lock` returns a plain
``threading.Lock``/``RLock`` unless debugging is enabled (the
``SBT_LOCK_DEBUG=1`` environment variable at import, or
:func:`enable` at runtime), so production hot paths pay nothing.
``serving/executor.py``, ``serving/registry.py``, ``serving/
batcher.py``, and ``telemetry/registry.py`` create their locks through
the factory. The plain-vs-instrumented choice is made ONCE, at lock
creation: :func:`enable` only affects locks created afterwards, so
objects built at import time (the process-wide telemetry registry)
are instrumented only when ``SBT_LOCK_DEBUG=1`` is set before the
process starts — the intended way to arm the full stack. Runtime
``enable()`` is for tests and tools that construct their serving
objects after the call.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "LockOrderError",
    "SyncWhileLockedError",
    "DebugLock",
    "make_lock",
    "enable",
    "enabled",
    "note_device_sync",
    "violations",
    "clear",
    "held_locks",
    "all_held_locks",
]


class LockOrderError(RuntimeError):
    """Acquiring this lock closes a cycle in the acquisition graph."""


class SyncWhileLockedError(RuntimeError):
    """A device sync ran while this thread held an instrumented lock."""


class _Held(threading.local):
    def __init__(self) -> None:
        # the DebugLock OBJECTS this thread holds, outermost first —
        # instances, not names: re-entrancy and same-name-different-
        # instance detection both need object identity
        self.stack: list["DebugLock"] = []
        # register this thread's stack for the cross-thread view
        # (all_held_locks, read by the flight recorder): the stack is
        # only MUTATED by its owner thread, readers copy under the
        # graph lock and tolerate a momentarily stale snapshot
        with _graph_lock:
            # prune dead threads here too, not only in all_held_locks()
            # (which only runs when a flight dump fires): a debug-armed
            # server spawns a handler thread per scrape, and a healthy
            # long-running process must not grow this dict forever
            alive = {t.ident for t in threading.enumerate()}
            for tid in [t for t in _all_stacks if t not in alive]:
                del _all_stacks[tid]
            _all_stacks[threading.get_ident()] = (
                threading.current_thread().name, self.stack,
            )


_graph_lock = threading.Lock()
# thread ident -> (thread name, that thread's held-lock stack object);
# feeds all_held_locks(); entries from dead threads are pruned on read
_all_stacks: dict[int, tuple[str, list]] = {}
_held = _Held()
# edge a -> b with the (a_site, b_site) witness that created it
_edges: dict[tuple[str, str], str] = {}
_violations: list[str] = []
_strict = False
_enabled = os.environ.get("SBT_LOCK_DEBUG", "") not in ("", "0")


def enable(on: bool = True, *, strict: bool = False) -> None:
    """Turn instrumentation on/off at runtime. ``strict=True`` raises
    on violation instead of recording it (the test-suite mode)."""
    global _enabled, _strict
    _enabled = bool(on)
    _strict = bool(strict)


def enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop the recorded graph and violations (between tests)."""
    with _graph_lock:
        _edges.clear()
        _violations.clear()


def violations() -> list[str]:
    with _graph_lock:
        return list(_violations)


def held_locks() -> tuple[str, ...]:
    """Names of instrumented locks the CURRENT thread holds, outermost
    first."""
    return tuple(lk.name for lk in _held.stack)


def all_held_locks() -> dict[str, tuple[str, ...]]:
    """Held instrumented locks across EVERY thread that has ever
    acquired one: ``name#ident`` -> lock names, outermost first (the
    ident disambiguates same-named threads — every MicroBatcher worker
    is "serving-batcher", and a dump that collapsed them would drop
    exactly the multi-batcher stacks an inversion post-mortem needs).
    The
    flight recorder snapshots this into failure dumps — the "who was
    holding what" a post-mortem starts from. Empty unless lock
    debugging is armed (plain locks are invisible by design); a
    thread's stack may be one acquisition stale, which is fine for a
    forensic snapshot."""
    alive = {t.ident for t in threading.enumerate()}
    out: dict[str, tuple[str, ...]] = {}
    with _graph_lock:
        for tid in [t for t in _all_stacks if t not in alive]:
            del _all_stacks[tid]
        for tid, (name, stack) in _all_stacks.items():
            names = tuple(lk.name for lk in list(stack))
            if names:
                out[f"{name}#{tid}"] = names
    return out


def _find_cycle(start: str) -> list[str] | None:
    """DFS from ``start`` through the edge set back to ``start``."""
    adj: dict[str, list[str]] = {}
    for a, b in _edges:
        adj.setdefault(a, []).append(b)
    path = [start]
    seen: set[str] = set()

    def dfs(node: str) -> bool:
        for nxt in adj.get(node, ()):
            if nxt == start:
                path.append(nxt)
                return True
            if nxt in seen:
                continue
            seen.add(nxt)
            path.append(nxt)
            if dfs(nxt):
                return True
            path.pop()
        return False

    return path if dfs(start) else None


def _record(msg: str, exc_type: type[RuntimeError]) -> None:
    with _graph_lock:
        _violations.append(msg)
    if _strict:
        raise exc_type(msg)


class DebugLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper that feeds the
    acquisition graph. Semantics (blocking, timeout, context manager,
    re-entrancy for ``rlock=True``) delegate to the wrapped lock."""

    def __init__(self, name: str, *, rlock: bool = False):
        self.name = name
        self._lock = threading.RLock() if rlock else threading.Lock()
        self._rlock = rlock

    # -- graph maintenance --------------------------------------------

    def _on_acquired(self) -> None:
        stack = _held.stack
        if self._rlock and any(h is self for h in stack):
            stack.append(self)  # re-entrant on THIS instance: no edges
            return
        msgs = []
        with _graph_lock:
            for h in stack:
                if h is self:
                    continue
                if h.name == self.name:
                    # two INSTANCES sharing a name (two registries, two
                    # executors): there is no global order between
                    # instances of one class, so nesting them is the
                    # classic symmetric-deadlock pattern — flag it even
                    # though the graph sees no a->b edge
                    msgs.append(
                        f"nested acquisition of two locks both named "
                        f"{self.name!r}: instances of one class have "
                        "no defined order (symmetric deadlock hazard)"
                    )
                    continue
                edge = (h.name, self.name)
                if edge not in _edges:
                    _edges[edge] = threading.current_thread().name
                    # only a NEW edge can close a new cycle
                    cyc = _find_cycle(self.name)
                    if cyc is not None:
                        msgs.append(
                            "lock-order cycle: "
                            + " -> ".join(cyc)
                            + f" (edge {h.name} -> {self.name} added "
                            f"by thread "
                            f"{threading.current_thread().name!r})"
                        )
        stack.append(self)
        try:
            for msg in msgs:
                _record(msg, LockOrderError)
        except LockOrderError:
            # strict mode raises out of acquire(): the caller never got
            # the lock, so it must not stay held (and the held-stack
            # must not keep reporting it) — the violation itself is
            # already recorded
            self._on_released()
            self._lock.release()
            raise

    def _on_released(self) -> None:
        stack = _held.stack
        # release order need not be LIFO; drop the innermost occurrence
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    # -- lock protocol -------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._on_acquired()
        return got

    def release(self) -> None:
        self._on_released()
        self._lock.release()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked() if not self._rlock else False

    def __repr__(self) -> str:
        return f"DebugLock({self.name!r}, rlock={self._rlock})"


def make_lock(name: str, *, rlock: bool = False):
    """A lock for subsystem ``name`` — plain and free in production,
    instrumented when lock debugging is on. ``name`` should be a stable
    dotted path (``serving.registry``): it is the node label in the
    acquisition graph, shared across instances of the same class so the
    graph reflects the DESIGN's order, not one object's."""
    if not _enabled:
        return threading.RLock() if rlock else threading.Lock()
    return DebugLock(name, rlock=rlock)


def note_device_sync(what: str = "device sync") -> None:
    """Called from sync sites (telemetry's device barrier) — records a
    hazard if the calling thread holds any instrumented lock. Cheap
    no-op when debugging is off."""
    if not _enabled:
        return
    held = held_locks()
    if held:
        _record(
            f"{what} while holding lock(s) {list(held)}: every waiter "
            "on those locks now queues behind the accelerator",
            SyncWhileLockedError,
        )


def acquisition_edges() -> list[tuple[str, str]]:
    """Snapshot of the recorded acquisition graph (for tests/
    debugging). Returns a list, not a generator: a generator would
    hold the graph lock across its yields and self-deadlock any
    consumer that acquires an instrumented lock mid-iteration."""
    with _graph_lock:
        return sorted(_edges)
