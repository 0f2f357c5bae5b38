"""Mesh construction for the 2-D ``(data, replica)`` layout.

The port of the JAX package's ``parallel/mesh.py``. A :class:`Mesh` is a
``(data, replica)`` array of ``torch.device``s with the JAX mesh's
``shape`` mapping; :mod:`~spark_bagging_tpu_torch.parallel.compat`'s
``shard_map`` runs one shard per position, each on its own thread and
device. On small-data, many-replica configurations the mesh is all
``replica``; on data too large for one card it is all ``data``;
anything between is a rectangle of the two.

Unlike a JAX mesh, a device may repeat: ``make_mesh(replica=4,
devices=["cuda:0"] * 4)`` runs four shards on one card (each shard its
own thread), which is how a one-card machine drives every sharded path,
and ``[torch.device("cpu")] * 8`` is the CPU parity tests' mesh.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

DATA_AXIS = "data"
REPLICA_AXIS = "replica"


class Mesh:
    """A ``(data, replica)`` grid of devices.

    ``devices`` is the numpy object array of ``torch.device``s, shape
    ``(data, replica)``; ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does; ``axis_names`` is ``(DATA_AXIS,
    REPLICA_AXIS)``.
    """

    axis_names = (DATA_AXIS, REPLICA_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(
                f"mesh devices must be a (data, replica) array, got "
                f"shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: int(self.devices.shape[0]),
                REPLICA_AXIS: int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, data_index: int, replica_index: int) -> torch.device:
        return self.devices[data_index, replica_index]

    @property
    def first_device(self) -> torch.device:
        return self.devices[0, 0]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.ravel())
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"replica={self.shape[REPLICA_AXIS]}, devices=[{devs}])")


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process (``cuda:0`` ... ``cuda:n-1``);
    raises where CUDA is absent (the port's device rule: the CPU only
    when asked for, here by passing ``devices=``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() without devices= builds a mesh over the CUDA "
            "devices and none is available; pass devices= (e.g. "
            "[torch.device('cpu')] * 8) to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    data: int = 1,
    replica: int | None = None,
    *,
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """Build a ``(data, replica)`` mesh over ``devices`` (default: every
    CUDA device). ``replica=None`` puts all remaining devices on the
    replica axis, the right default for many-replica fits. A device may
    appear more than once."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    n = len(devices)
    if data < 1 or (replica is not None and replica < 1):
        raise ValueError(
            f"mesh axes must be >= 1, got data={data}, replica={replica}"
        )
    if replica is None:
        if n % data != 0:
            raise ValueError(f"{n} devices not divisible by data={data}")
        replica = n // data
    if data * replica != n:
        raise ValueError(
            f"mesh {data}x{replica} needs {data * replica} devices, "
            f"got {n}"
        )
    for d in devices:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"mesh devices must be cuda or cpu, got {d}")
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {d} was requested but no CUDA device is "
                "available")
    dev_array = np.empty((data, replica), dtype=object)
    for i, d in enumerate(devices):
        dev_array[i // replica, i % replica] = d
    return Mesh(dev_array)


def device_put_rows(X, mesh: Mesh) -> list[torch.Tensor]:
    """Host matrix -> one row block per data shard, each on its shard's
    devices (replicated over ``replica``): the placement step of a data
    mesh, returned as ``[[block on (i, j) for j] for i]``. Row count
    must be divisible by the data-axis size (``pad_rows`` /
    ``pad_rows_X`` first)."""
    if X.shape[0] % mesh.shape[DATA_AXIS] != 0:
        raise ValueError(
            f"{X.shape[0]} rows not divisible by data-axis size "
            f"{mesh.shape[DATA_AXIS]}; pad rows first"
        )
    Xt = torch.as_tensor(np.asarray(X, np.float32)
                         if not isinstance(X, torch.Tensor) else X)
    blocks = torch.chunk(Xt, mesh.shape[DATA_AXIS], dim=0)
    return [[blk.to(mesh.device(i, j))
             for j in range(mesh.shape[REPLICA_AXIS])]
            for i, blk in enumerate(blocks)]
