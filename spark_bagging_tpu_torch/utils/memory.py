"""Memory-aware automatic ``chunk_size`` resolution.

``chunk_size`` bounds how many replicas fit at once (ensemble.py).
``None`` means: estimate the per-replica working set from the learner's
bytes model (``fit_workset_bytes``) plus the engine's own per-replica
temporaries, compare it with a safety-discounted memory budget, and
either fit every replica in one chunk or take the largest chunk that
fits. On the card the budget is the free device memory
(``torch.cuda.mem_get_info``); on the CPU it is a fixed figure.

:func:`device_memory_stats` and :func:`host_rss_bytes` are the
exposition server's process gauges (``sbt_process_device_*``,
``sbt_process_rss_bytes``) and the capacity plane's device view; both
are safe to call from a scrape thread.
"""

from __future__ import annotations

import os

import torch

SAFETY = 0.35
# budget on the CPU, where no device reports free memory
FALLBACK_BUDGET_BYTES = 4 * 2**30
# the bootstrap draw's int64 threefry temporaries per row and replica
# (ops/prng.py: a handful of live (R, n) int64 tensors in eager mode)
BOOTSTRAP_BYTES_PER_ROW = 48.0


def device_memory_budget(device: torch.device, safety: float = SAFETY) -> float:
    """Free bytes on ``device`` times the safety discount. Memory that
    torch's caching allocator holds but no tensor uses counts as free,
    so a second fit in the process budgets like the first."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return (free + cached) * safety
    return FALLBACK_BUDGET_BYTES * safety


# device -> total bytes (``torch.cuda.mem_get_info``'s second value):
# read once a device, a scrape reads the cache
_bytes_limit: dict[int, int] = {}


def device_memory_stats() -> list[dict] | None:
    """Per-device memory stats of the caching allocator, or ``None`` on
    the CPU and in a process that has not initialized CUDA. Each entry
    carries the JAX package's keys: ``{"id", "platform", "bytes_in_use",
    "bytes_limit", "peak_bytes_in_use"}`` — ``bytes_in_use`` and
    ``peak_bytes_in_use`` are the allocator's ``allocated_bytes.all``
    current and peak, ``bytes_limit`` the device's total memory. Mirrored
    as ``sbt_process_device_*`` gauges on scrape (telemetry/server.py)
    and carried in ``/debug/capacity``.

    A scrape must never create a CUDA context (hundreds of MB a
    process), never synchronize and never walk the allocator's segments
    (``memory_snapshot``): this reads the allocator's counters only, and
    only for devices whose allocator this process has used."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    out = []
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats.get("reserved_bytes.all.peak"):
            continue  # never allocated here: it may hold no context
        limit = _bytes_limit.get(d)
        if limit is None:
            limit = _bytes_limit[d] = int(torch.cuda.mem_get_info(d)[1])
        out.append({
            "id": d,
            "platform": "gpu",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": limit,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
        })
    return out or None


def host_rss_bytes() -> int | None:
    """Current resident set size of THIS process, or None when the
    platform exposes neither ``/proc`` nor ``getrusage``.

    ``/proc/self/statm`` gives the live value on Linux (field 2 is
    resident pages); the ``ru_maxrss`` fallback is the lifetime PEAK
    (kilobytes on Linux, bytes on macOS) — still the right order of
    magnitude for a leak-watch gauge, but biased HIGH: a peak never
    shrinks, so after a transient allocation it over-reports current
    RSS (a floor on the peak, not on what is resident now).
    """
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(peak) if sys.platform == "darwin" else int(peak) * 1024
    except Exception:  # noqa: BLE001 — observability must not raise
        return None


def auto_chunk_size(
    learner,
    n_rows: int,
    n_subspace: int,
    n_outputs: int,
    n_replicas: int,
    device: torch.device,
    budget_bytes: float | None = None,
    n_features: int | None = None,
    bootstrap_features: bool = False,
) -> int | None:
    """Resolve ``chunk_size=None`` to a concrete chunk, or None (all
    replicas in one chunk). A gathered feature subspace adds its
    per-replica copy of X (and whatever the learner gathers with it:
    a dense tree's indicator slices). The learner's replica-invariant
    prepared state (a tree's bin codes) comes off the budget once."""
    per = learner.fit_workset_bytes(n_rows, n_subspace, n_outputs,
                                    device=device)
    if per is None:
        return None  # unmodeled learner: one chunk
    per += BOOTSTRAP_BYTES_PER_ROW * n_rows
    if n_features is not None and (n_subspace < n_features
                                   or bootstrap_features):
        per += learner.subspace_gather_bytes(n_rows, n_subspace,
                                             device=device)
    if budget_bytes is None:
        budget_bytes = device_memory_budget(device)
    budget_bytes -= learner.prepared_bytes(
        n_rows, n_subspace if n_features is None else n_features,
        device=device)
    if per * n_replicas <= budget_bytes:
        return None
    return max(1, min(n_replicas, int(budget_bytes // per)))
