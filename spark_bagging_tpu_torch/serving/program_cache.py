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
- ``variant`` — which closure over those params the program runs
  (voting mode, replica chunking, identity-subspace fast path);
- ``bucket`` — the row count the program was built for;
- ``mesh`` — always ``None`` here (mesh serving is ROADMAP Queue A 12);
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
``sbt_program_cache_*`` telemetry. The JAX package's capacity-plane
hooks (per-model attribution, pin policies) are ROADMAP Queue A 15.
"""

from __future__ import annotations

import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock


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


def forward_variant(model: Any) -> str:
    """The static-closure component of a :class:`ProgramKey`: everything
    besides the weights that changes what the aggregated forward
    computes."""
    return (
        f"aggregated|voting={getattr(model, 'voting', None)}"
        f"|chunk={model._eff_chunk() if hasattr(model, '_eff_chunk') else None}"
        f"|ident={getattr(model, '_identity_subspace', None)}"
    )


def mesh_shape(mesh: Any) -> tuple[int, int] | None:
    """The key's mesh component: ``None`` for the single-device
    executors the port builds; a mesh raises (not ported yet)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh serving (ROADMAP Queue A 12: parallel/)")
    return None


class _Entry:
    """A weak reference to one program plus its residency facts: bytes
    (where the program reports them), hit counts, and a monotonic
    insert/hit sequence. ``compiled`` is None once the program died."""

    __slots__ = ("_ref", "nbytes", "hits", "seq_inserted",
                 "seq_last_hit", "ts_inserted", "ts_last_hit")

    def __init__(self, compiled: Any, seq: int):
        self._ref = weakref.ref(compiled)
        nbytes = getattr(compiled, "nbytes", None)
        self.nbytes = int(nbytes) if nbytes is not None else None
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
    """Bounded, thread-safe LRU index ``ProgramKey -> live program``."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
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
        telemetry.inc("sbt_program_cache_hits_total" if prog is not None
                      else "sbt_program_cache_misses_total")
        return prog

    def put(self, key: ProgramKey, compiled: Any) -> Any:
        """Insert-if-absent; returns the winning program (the first
        insert wins, so racing builders converge on one program)."""
        if faults.ACTIVE is not None:
            # chaos probe: a failed insert surfaces to the building
            # caller (executor build, swap pre-capture) exactly where an
            # allocation failure would
            faults.fire("program_cache.put", bucket=key.bucket)
        n_evicted = 0
        with self._lock:
            existing = self._entries.get(key)
            prog = None if existing is None else existing.compiled
            if prog is not None:
                self._entries.move_to_end(key)
                return prog
            self._prune()
            self._seq += 1
            self._entries[key] = _Entry(compiled, self._seq)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                n_evicted += 1
            size = len(self._entries)
        if n_evicted:
            telemetry.inc("sbt_program_cache_evictions_total",
                          float(n_evicted))
        telemetry.set_gauge("sbt_program_cache_entries", float(size))
        return compiled

    def drop_fingerprint(self, fingerprint: str) -> int:
        """Remove every entry built from ``fingerprint`` (a retired
        model's programs: no later executor adopts them). Returns the
        number dropped."""
        with self._lock:
            keys = [k for k in self._entries if k.fingerprint == fingerprint]
            for k in keys:
                del self._entries[k]
            size = len(self._entries)
        if keys:
            telemetry.inc("sbt_program_cache_evictions_total",
                          float(len(keys)))
            telemetry.set_gauge("sbt_program_cache_entries", float(size))
        return len(keys)

    def clear(self) -> None:
        """Drop every entry (tests simulating a fresh process)."""
        with self._lock:
            self._entries.clear()
        telemetry.set_gauge("sbt_program_cache_entries", 0.0)

    def _prune(self) -> None:
        """Drop the entries whose program died (under ``self._lock``)."""
        dead = [k for k, e in self._entries.items() if e.compiled is None]
        for k in dead:
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
