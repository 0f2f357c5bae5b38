"""Unified program cache — one bucket program, built once, reused
everywhere in the process.

The port of the JAX package's ``serving/program_cache.py``. There an
entry is a compiled XLA executable; here it is a bucket program of
``serving/executor.py``: one captured CUDA graph with its static input
and output buffers on the card, or the eager forward at the bucket's
shape on the CPU. Two live executors for the same fitted model (a
swap to the same weights, a second registry, a checkpoint loaded under
a second name) share one capture per bucket.

Key contract (why each component is in the key):

- ``fingerprint`` — sha256 of the fitted params/subspaces tree plus
  estimator class, task, feature width and class set
  (:func:`fingerprint_params`): two models that would build different
  programs must never share an entry;
- ``variant`` — which closure over those params the program runs:
  the aggregated serving forward or the per-replica twin of the
  quality plane's disagreement tap, and the voting mode, replica
  chunking and identity-subspace fast path;
- ``bucket`` — the row count the program was built for;
- ``mesh`` — the serving mesh's ``(data, replica)`` shape, ``None`` on
  one device: a mesh program and a single-device one never share;
- ``torch_version`` / ``cuda_version`` / ``device_kind`` — a program is
  only meaningful on the toolchain and card that built it.

The cache keeps no program alive. An entry is a weak reference: a
program (its graph, pool segments, static and pinned buffers, and the
model tensors the graph reads, which the program holds) frees with the
last executor that serves it. The pre-captures of a swap that rolled
back, or an executor dropped without a swap, leave nothing on the card,
and an adopted program can never outlive the tensors it reads. The
index is bounded (LRU eviction at ``capacity`` entries, dead entries
pruned as they are met) and thread-safe; lookups and inserts count
``sbt_program_cache_*`` telemetry.

A batch predict (``BaggingClassifier.predict_proba`` &c.) looks its
program up under the same key, bucket = its row count: it replays a
serving program where one exists, and a miss records an
:class:`EagerBatchProgram` (the eager forward: 0 program bytes, source
``"eager"``), which the estimator holds. A serving executor on the card never adopts an
eager batch program: it captures its graph and replaces the entry.

Each entry carries residency metadata for the capacity plane
(``telemetry/capacity.py``): the program's device bytes and their
source (``"graph_pool"``, or ``"unmeasured"`` for the CPU's eager
program), hit counts and a monotonic insert sequence. With the plane
armed, hit/miss/eviction counters gain ``model=`` owner labels (the
unlabeled totals keep their meaning) and every eviction is charged to
its owner. An entry whose program died leaves the index — and with it
the plane's ledger, which reads the index — at the next prune.
"""

from __future__ import annotations

import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.telemetry import capacity as _capacity


class ProgramKey(NamedTuple):
    """Identity of one bucket program — see the module docstring."""

    fingerprint: str
    variant: str
    bucket: int
    mesh: tuple[int, int] | None
    torch_version: str
    cuda_version: str
    device_kind: str


def toolchain_id(device: torch.device | str = "cpu") -> tuple[str, str, str]:
    """``(torch version, CUDA version, device name)`` of the programs
    built for ``device`` — the shared tail of every :class:`ProgramKey`."""
    device = torch.device(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    return torch.__version__, str(torch.version.cuda), kind


def _leaves(tree: Any, prefix: str = ""):
    """``(path, tensor)`` of every leaf of a tree of dicts, tuples and
    tensors, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor (or array) of a tree of dicts, tuples and
    tensors."""
    return sum(int(getattr(leaf, "nbytes", 0)) for _p, leaf in _leaves(tree))


def fingerprint_params(model_cls: type, task: str, n_features: int,
                       classes, params: Any, subspaces: Any) -> str:
    """sha256 identity of the program a forward over ``params`` builds:
    leaf bytes, shapes, dtypes and tree paths, plus the estimator class,
    task, feature width and class set."""
    h = hashlib.sha256()
    h.update(
        f"{model_cls.__module__}:{model_cls.__qualname__}|{task}|"
        f"{n_features}\n".encode()
    )
    if classes is not None:
        c = np.asarray(classes)
        h.update(str(c.dtype).encode())
        h.update(c.tobytes())
    for path, leaf in _leaves((params, subspaces)):
        a = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf))
        h.update(path.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def fingerprint_model(model: Any) -> str:
    """:func:`fingerprint_params` for a fitted estimator (cached on the
    instance, invalidated when a refit rebinds ``ensemble_`` — the hash
    reads every parameter byte back from the device)."""
    token = getattr(model, "_fp_token", None)
    if token is not None and token[0] is model.ensemble_:
        return token[1]
    fp = fingerprint_params(
        type(model), model.task, int(model.n_features_in_),
        getattr(model, "classes_", None), model.ensemble_,
        model.subspaces_,
    )
    try:
        model._fp_token = (model.ensemble_, fp)
    except AttributeError:
        pass  # slotted/frozen estimators just recompute
    return fp


def forward_variant(model: Any, kind: str = "aggregated") -> str:
    """The static-closure component of a :class:`ProgramKey`: everything
    besides the weights that changes what the forward computes.
    ``kind`` tells the aggregated serving program from its per-replica
    (disagreement-tap) twin."""
    return (
        f"{kind}|voting={getattr(model, 'voting', None)}"
        f"|chunk={model._eff_chunk() if hasattr(model, '_eff_chunk') else None}"
        f"|ident={getattr(model, '_identity_subspace', None)}"
    )


def mesh_shape(mesh: Any) -> tuple[int, int] | None:
    """The key's mesh component: ``None`` for a single-device program,
    the mesh's ``(data, replica)`` sizes otherwise."""
    if mesh is None:
        return None
    from spark_bagging_tpu_torch.parallel.mesh import DATA_AXIS, REPLICA_AXIS

    return (int(mesh.shape.get(DATA_AXIS, 1)),
            int(mesh.shape.get(REPLICA_AXIS, 1)))


class EagerBatchProgram:
    """A batch predict's program: the aggregated forward run eagerly on
    whatever rows it is given (``prog(X)``), or, as a serving program,
    on one host slab (``run``). It captures nothing and holds no device
    memory beyond the model's own parameters (which the capacity plane
    counts as the model's), so its program bytes are 0, measured, with
    the source ``"eager"``; its cost is counted on first read."""

    nbytes = 0
    bytes_source = "eager"
    row_axis = 0

    def __init__(self, fn, params, subspaces, bucket: int,
                 n_features: int):
        self._fn, self._params, self._subspaces = fn, params, subspaces
        self._shape = (int(bucket), int(n_features))
        self._cost = None

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return self._fn(self._params, self._subspaces, X)

    def run(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        X = torch.as_tensor(Xp, device=self._subspaces.device)
        return self(X)[:fill].cpu().numpy()

    @property
    def cost(self) -> dict:
        """The forward's cost at its row count (``counted_forward``),
        counted once, when a serving executor first reads it."""
        if self._cost is None:
            from spark_bagging_tpu_torch.serving.executor import (
                counted_forward,
            )

            x = torch.zeros(self._shape, dtype=torch.float32,
                            device=self._subspaces.device)
            _, self._cost = counted_forward(self._fn, self._params,
                                            self._subspaces, x)
        return self._cost


class _Entry:
    """A weak reference to one program plus the residency facts the
    capacity plane's explainer reads: bytes and their measurement
    source, hit counts, a monotonic insert/hit sequence (a
    workload-pure event clock), and wall-clock timestamps for live
    last-hit-age reporting only. ``compiled`` is None once the program
    died."""

    __slots__ = ("_ref", "nbytes", "source", "hits", "seq_inserted",
                 "seq_last_hit", "ts_inserted", "ts_last_hit")

    def __init__(self, compiled: Any, nbytes: int | None, source: str,
                 seq: int):
        self._ref = weakref.ref(compiled)
        self.nbytes = nbytes
        self.source = source
        self.hits = 0
        self.seq_inserted = seq
        self.seq_last_hit = seq
        self.ts_inserted = time.time()
        self.ts_last_hit: float | None = None

    @property
    def compiled(self) -> Any | None:
        return self._ref()


# sbt-lint: shared-state
class ProgramCache:
    """Bounded, thread-safe LRU index ``ProgramKey -> live program``.

    ``pin_policy`` is opt-in demand-aware victim selection: a
    fingerprint predicate whose True entries are skipped in LRU
    eviction order (``tenancy/residency.cache_pin_policy`` supplies
    one). None (default) keeps strict LRU.
    """

    def __init__(self, capacity: int = 256,
                 pin_policy: Callable[[str], bool] | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._pin_policy = pin_policy
        self._lock = make_lock("serving.program_cache")
        self._entries: OrderedDict[ProgramKey, _Entry] = OrderedDict()
        self._seq = 0

    def get(self, key: ProgramKey) -> Any | None:
        """The cached program for ``key``, or None (counted as a
        hit/miss either way)."""
        with self._lock:
            entry = self._entries.get(key)
            prog = None if entry is None else entry.compiled
            if prog is not None:
                self._entries.move_to_end(key)
                self._seq += 1
                entry.hits += 1
                entry.seq_last_hit = self._seq
                entry.ts_last_hit = time.time()
            elif entry is not None:
                del self._entries[key]  # its last executor is gone
        name = ("sbt_program_cache_hits_total" if prog is not None
                else "sbt_program_cache_misses_total")
        telemetry.inc(name)
        cap = _capacity.ACTIVE
        if cap is not None:
            owner = cap.owner_label(key.fingerprint)
            if owner is not None:
                telemetry.inc(name, labels={"model": owner})
        return prog

    def get_or_build(self, key: ProgramKey,
                     build: Callable[[], Any]) -> tuple[Any, bool]:
        """``(program, was_hit)``. The build runs outside the cache lock;
        racing same-key builds both run and the first ``put`` wins."""
        prog = self.get(key)
        if prog is not None:
            return prog, True
        return self.put(key, build()), False

    def put(self, key: ProgramKey, compiled: Any,
            replace: bool = False) -> Any:
        """Insert-if-absent; returns the winning program (the first
        insert wins, so racing builds converge on one program).
        ``replace=True`` overwrites a live entry (a serving capture
        taking the place of an eager batch program)."""
        if faults.ACTIVE is not None:
            # chaos probe: a failed insert surfaces to the building
            # caller (executor build, swap pre-capture) exactly where an
            # allocation failure would
            faults.fire("program_cache.put", bucket=key.bucket)
        # measured at the build (the program carries its bytes), read
        # outside the lock
        nbytes, source = _capacity.executable_bytes(compiled)
        evicted: list[tuple[ProgramKey, _Entry]] = []
        with self._lock:
            existing = self._entries.get(key)
            prog = None if existing is None else existing.compiled
            if prog is not None and not replace:
                self._entries.move_to_end(key)
                return prog
            self._entries.pop(key, None)
            self._prune()
            self._seq += 1
            self._entries[key] = _Entry(compiled, nbytes, source,
                                        self._seq)
            pin_violations = 0
            while len(self._entries) > self.capacity:
                victim, violated = self._pick_victim_locked(key)
                pin_violations += int(violated)
                evicted.append((victim, self._entries.pop(victim)))
            size = len(self._entries)
            total_bytes = self._bytes_locked()
        if pin_violations:
            # the pinned set alone overflows the cache: a pinned entry
            # had to go — unlabeled total first, then the locating twin
            telemetry.inc("sbt_tenancy_pin_violations_total",
                          float(pin_violations))
            telemetry.inc("sbt_tenancy_pin_violations_total",
                          float(pin_violations),
                          labels={"level": "cache"})
        self._charge(evicted)
        telemetry.set_gauge("sbt_program_cache_entries", float(size))
        telemetry.set_gauge("sbt_program_cache_bytes", float(total_bytes))
        return compiled

    def _pick_victim_locked(
            self, protect: ProgramKey) -> tuple[ProgramKey, bool]:
        """The next eviction victim (never ``protect``, the entry just
        inserted): the strict LRU head without a pin policy; with one,
        the first UNPINNED key in LRU order, and when everything is
        pinned the LRU head anyway, flagged (``True`` in the return)."""
        if self._pin_policy is None:
            return next(iter(self._entries)), False
        fallback: ProgramKey | None = None
        for k in self._entries:
            if k == protect:
                continue
            if fallback is None:
                fallback = k
            if not self._pin_policy(k.fingerprint):
                return k, False
        if fallback is None:  # capacity 1 and only the fresh insert
            return protect, False
        return fallback, True

    def _bytes_locked(self) -> int:
        """Measured bytes of the resident entries (under the lock)."""
        return sum(e.nbytes or 0 for e in self._entries.values())

    def _charge(self, evicted: list[tuple[ProgramKey, _Entry]]) -> None:
        """Count evicted (or dropped) entries: the unlabeled total, and
        with the capacity plane armed each entry charged to its owner
        through the plane's eviction seam plus the owner-labeled twin."""
        if not evicted:
            return
        telemetry.inc("sbt_program_cache_evictions_total",
                      float(len(evicted)))
        cap = _capacity.ACTIVE
        if cap is None:
            return
        for ekey, entry in evicted:
            owner = cap.observe_eviction(
                fingerprint=ekey.fingerprint, bucket=ekey.bucket,
                variant=ekey.variant, nbytes=entry.nbytes,
                seq=entry.seq_inserted,
            )
            if owner != _capacity.UNATTRIBUTED:
                telemetry.inc("sbt_program_cache_evictions_total",
                              labels={"model": owner})

    def drop_fingerprint(self, fingerprint: str) -> int:
        """Remove every entry built from ``fingerprint`` (a retired
        model's programs: no later executor adopts them), charged
        through the same counters and capacity-plane eviction seam as
        pressure evictions, so the ledger's attribution stays
        reconciled. Returns the number dropped."""
        with self._lock:
            dropped = [(k, self._entries.pop(k)) for k in
                       [k for k in self._entries
                        if k.fingerprint == fingerprint]]
            size = len(self._entries)
            total_bytes = self._bytes_locked()
        if not dropped:
            return 0
        self._charge(dropped)
        telemetry.set_gauge("sbt_program_cache_entries", float(size))
        telemetry.set_gauge("sbt_program_cache_bytes", float(total_bytes))
        return len(dropped)

    def drop_batch_programs(self) -> int:
        """Remove every :class:`EagerBatchProgram` entry (not counted as
        evictions: the estimators that built them still hold them).
        Returns the number removed."""
        with self._lock:
            keys = [k for k, e in self._entries.items()
                    if isinstance(e.compiled, EagerBatchProgram)]
            for k in keys:
                del self._entries[k]
            size = len(self._entries)
            total_bytes = self._bytes_locked()
        telemetry.set_gauge("sbt_program_cache_entries", float(size))
        telemetry.set_gauge("sbt_program_cache_bytes", float(total_bytes))
        return len(keys)

    def clear(self) -> None:
        """Drop every entry (tests simulating a fresh process)."""
        with self._lock:
            self._entries.clear()
        telemetry.set_gauge("sbt_program_cache_entries", 0.0)
        telemetry.set_gauge("sbt_program_cache_bytes", 0.0)

    def _prune(self) -> None:
        """Drop the entries whose program died (under ``self._lock``)."""
        dead = [k for k, e in self._entries.items() if e.compiled is None]
        for k in dead:
            # sbt-lint: disable=shared-state-unlocked — every caller holds self._lock (put, stats, entries, __len__)
            del self._entries[k]

    def stats(self) -> dict:
        with self._lock:
            self._prune()
            entries = list(self._entries.values())
        return {"entries": len(entries),
                "capacity": self.capacity,
                "bytes": sum(e.nbytes or 0 for e in entries),
                "unmeasured": sum(1 for e in entries if e.nbytes is None)}

    def snapshot(self) -> dict:
        """Every entry LRU-first (position 0 is next to evict) with its
        key fields and metadata, plus the totals. Point-in-time
        consistent: one lock hold."""
        with self._lock:
            self._prune()
            entries = [{
                "lru_position": pos,
                "fingerprint": key.fingerprint,
                "variant": key.variant,
                "bucket": key.bucket,
                "mesh": key.mesh,
                "bytes": e.nbytes,
                "source": e.source,
                "hits": e.hits,
                "seq_inserted": e.seq_inserted,
                "seq_last_hit": e.seq_last_hit,
                "ts_last_hit": e.ts_last_hit,
            } for pos, (key, e) in enumerate(self._entries.items())]
        return {
            "capacity": self.capacity,
            "entries_total": len(entries),
            "bytes_total": sum(e["bytes"] or 0 for e in entries),
            "unmeasured_total": sum(1 for e in entries
                                    if e["bytes"] is None),
            "entries": entries,
        }

    def __len__(self) -> int:
        with self._lock:
            self._prune()
            return len(self._entries)


_default: ProgramCache | None = None
_default_lock = make_lock("serving.program_cache.default")


def cache() -> ProgramCache:
    """The process-wide cache every producer shares."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ProgramCache()
        return _default


def install(c: ProgramCache | None) -> ProgramCache | None:
    """Swap the process-wide cache, returning the previous one (a
    save/restore seam for tests). ``None`` restores lazy re-creation."""
    global _default
    with _default_lock:
        prev = _default
        _default = c
    return prev


def clear() -> None:
    """Reset the process-wide cache (tests; a no-op if never used)."""
    with _default_lock:
        if _default is not None:
            _default.clear()
