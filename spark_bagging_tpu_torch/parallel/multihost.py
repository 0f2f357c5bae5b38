"""Multi-process array plumbing: the port of the JAX package's
``parallel/multihost.py``.

A multi-process run is one global ``(data, replica)`` mesh over the
devices of every process joined through ``initialize_distributed``
(``parallel/distributed.py``). The two host/device seams the estimator
needs:

- **in**: every process holds the same host matrix (bagging's
  broadcast-data design, no shuffle); :func:`global_put` places only
  this process's shards of it, on their devices, as a
  :class:`~spark_bagging_tpu_torch.parallel.compat.LocalShards`;
- **out**: the outputs of a process-spanning ``shard_map`` hold only
  this process's shards; :func:`to_host` gathers them into one complete
  numpy array on every process, in mesh order.

Both work on a 1-process mesh too, so the estimator calls them on every
mesh path.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch.parallel.compat import (
    LocalShards,
    PartitionSpec,
    canonical_positions,
)
from spark_bagging_tpu_torch.parallel.distributed import process_index
from spark_bagging_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def is_multiprocess_mesh(mesh: Mesh | None) -> bool:
    """Does the mesh span devices owned by more than one process?"""
    return mesh is not None and mesh.is_multiprocess


def _place(piece: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and piece.device.type == "cpu":
        # pinned and asynchronous: the host goes on placing the next
        # shard while this one copies
        return piece.pin_memory().to(device, non_blocking=True)
    return piece.to(device)


def global_put(x: Any, mesh: Mesh, spec: PartitionSpec) -> LocalShards:
    """Place a host array (numpy or a tensor) sharded per ``spec``:
    each of this process's positions gets its shard on its device (one
    copy per device and shard, shared by the positions that repeat a
    device). Every process must pass the same value (bagging broadcasts
    the dataset), and places only its own shards."""
    from spark_bagging_tpu_torch import telemetry

    was_host = not (isinstance(x, torch.Tensor) and x.device.type != "cpu")
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        # a read-only view (a zero-copy Arrow chunk) is copied once
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    t = x
    axis = spec[0] if len(spec) else None
    size = 1 if axis is None else mesh.shape[axis]
    if t.shape[0] % size != 0:
        raise ValueError(
            f"leading size {t.shape[0]} not divisible by the {axis!r} "
            f"axis size {size}")
    step = t.shape[0] // size
    placed: dict[tuple, torch.Tensor] = {}
    shards = {}
    for ix in mesh.local_positions:
        dev = mesh.device(*ix)
        k = None if axis is None else ix[0 if axis == DATA_AXIS else 1]
        if (dev, k) not in placed:
            piece = t if k is None else t[k * step:(k + 1) * step]
            placed[(dev, k)] = _place(piece, dev)
        shards[ix] = placed[(dev, k)]
    if telemetry.enabled() and was_host:
        # host->device volume by process: the bytes of THIS process's
        # shards, not the whole array — every process passes the full
        # host matrix but places only its shards, so counting x's bytes
        # would overstate the volume n_processes-fold and hide the skew
        # the label exists to show
        nbytes = float(sum(p.numel() * p.element_size()
                           for p in placed.values()))
        telemetry.inc("sbt_h2d_bytes_total", nbytes,
                      labels={"process": process_index()})
    return LocalShards(mesh, spec, shards)


def _assemble_host(pieces: list[np.ndarray], axis: str | None) -> np.ndarray:
    return pieces[0] if axis is None else np.concatenate(pieces, axis=0)


def to_host(x: Any) -> np.ndarray:
    """Device->host barrier that works on process-spanning outputs.

    A tensor (always the case off a mesh and on a 1-process mesh) is
    copied to numpy. :class:`LocalShards` of a process-spanning mesh are
    gathered over every process (``all_gather_object`` on the default
    group) so each returns the complete value, assembled in mesh order
    from the shards one process reads (``_assemble``'s); a collective,
    which every process must reach."""
    if isinstance(x, LocalShards):
        order = canonical_positions(x.spec, x.mesh)
        if not x.mesh.is_multiprocess:
            return _assemble_host(
                [x.shards[ix].detach().cpu().numpy() for ix in order],
                x.axis)
        import torch.distributed as dist

        from spark_bagging_tpu_torch import telemetry

        with telemetry.span("to_host_gather",
                            metric="sbt_collective_seconds",
                            process=process_index()):
            # sbt-lint: disable=host-sync-in-span — the gather span exists to TIME this d2h collective; the pull is the phase
            mine = {k: x.shards[ix].detach().cpu().numpy()
                    for k, ix in enumerate(order) if x.mesh.is_local(ix)}
            parts: list = [None] * dist.get_world_size()
            dist.all_gather_object(parts, mine)
            merged: dict[int, np.ndarray] = {}
            for part in parts:
                merged.update(part)
            out = _assemble_host([merged[k] for k in range(len(order))],
                                 x.axis)
        telemetry.inc("sbt_d2h_bytes_total", float(out.nbytes),
                      labels={"process": process_index()})
        return out
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_local(x: Any, device: torch.device) -> Any:
    """A tree of tensors on ``device``: :class:`LocalShards` leaves
    gathered through :func:`to_host`, tensors moved. The fitted state of
    a process-spanning mesh is kept whole in every process this way, as
    in one process."""
    if isinstance(x, dict):
        return {k: to_local(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_local(v, device) for v in x)
    if isinstance(x, LocalShards):
        return torch.from_numpy(to_host(x)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x
