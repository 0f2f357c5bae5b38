"""Memory-aware automatic ``chunk_size`` resolution.

``chunk_size`` bounds how many replicas fit at once (ensemble.py).
``None`` means: estimate the per-replica working set from the learner's
bytes model (``fit_workset_bytes``) plus the engine's own per-replica
temporaries, compare it with a safety-discounted memory budget, and
either fit every replica in one chunk or take the largest chunk that
fits. On the card the budget is the free device memory
(``torch.cuda.mem_get_info``); on the CPU it is a fixed figure.
"""

from __future__ import annotations

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
