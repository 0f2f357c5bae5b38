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

After ``initialize_distributed`` joins several processes, every process
calls ``make_mesh`` with its own devices (``devices=``, default its CUDA
devices): they are gathered in process order, the analog of
``jax.devices()`` across processes, and laid out as in one process, so
a ``(2, 2)`` mesh over two processes of two devices each puts process 0
on data row 0 and process 1 on row 1. The mesh records the process
that owns each position, and creates, once and in the same order in
every process, one gloo subgroup for each collective group whose
members span processes (``parallel/compat.py`` exchanges through it).
"""

from __future__ import annotations

import threading
from typing import Any, Sequence

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

    def __init__(self, devices: np.ndarray,
                 processes: np.ndarray | None = None, rank: int = 0):
        if devices.ndim != 2:
            raise ValueError(
                f"mesh devices must be a (data, replica) array, got "
                f"shape {devices.shape}")
        self.devices = devices
        #: the process that owns each position, shape ``(data, replica)``
        self.processes = (np.zeros(devices.shape, dtype=np.int64)
                          if processes is None else processes)
        #: this process's rank
        self.rank = int(rank)
        # (axis, other coordinate) -> gloo subgroup, for the groups
        # whose members span processes (make_mesh creates them)
        self.subgroups: dict[tuple[str, int], Any] = {}
        #: this process's cross-process exchanges and the host bytes it
        #: staged for them (``compat._Group``)
        self.exchanges = 0
        self.staged_bytes = 0
        self._stats_lock = threading.Lock()

    def count_exchange(self, nbytes: int) -> None:
        with self._stats_lock:
            self.exchanges += 1
            self.staged_bytes += int(nbytes)

    @property
    def is_multiprocess(self) -> bool:
        """Do the mesh's positions belong to more than one process?"""
        return len(set(self.processes.ravel().tolist())) > 1

    def is_local(self, index: tuple[int, int]) -> bool:
        return int(self.processes[index]) == self.rank

    @property
    def local_positions(self) -> list[tuple[int, int]]:
        """This process's positions, in row-major mesh order."""
        D, R = self.devices.shape
        return [(i, j) for i in range(D) for j in range(R)
                if self.is_local((i, j))]

    @property
    def local_devices(self) -> list[torch.device]:
        return [self.device(*ix) for ix in self.local_positions]

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

    @property
    def home_device(self) -> torch.device:
        """Where this process keeps a fit's gathered state: its first
        position's device (the mesh's first device in one process)."""
        return self.device(*self.local_positions[0])

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
    appear more than once. In a joined multi-process run every process
    calls this with its own devices, which are laid out after those of
    the processes before it (a collective call)."""
    from spark_bagging_tpu_torch.parallel import distributed

    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    local = list(devices)
    owners = [0] * len(devices)
    rank = distributed.process_index()
    if distributed.process_count() > 1:
        import torch.distributed as dist

        parts: list = [None] * distributed.process_count()
        dist.all_gather_object(parts, [str(d) for d in devices])
        devices = [torch.device(d) for part in parts for d in part]
        owners = [p for p, part in enumerate(parts) for _ in part]
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
    for d in local:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {d} was requested but no CUDA device is "
                "available")
    dev_array = np.empty((data, replica), dtype=object)
    for i, d in enumerate(devices):
        dev_array[i // replica, i % replica] = d
    mesh = Mesh(dev_array,
                np.asarray(owners, dtype=np.int64).reshape(data, replica),
                rank)
    if mesh.is_multiprocess:
        _create_subgroups(mesh)
    return mesh


def group_members(mesh: Mesh, axis: str, other: int) -> list[tuple[int, int]]:
    """The positions of one collective group, in shard order: the
    ``axis`` members at coordinate ``other`` of the other axis."""
    D, R = mesh.devices.shape
    if axis == DATA_AXIS:
        return [(i, other) for i in range(D)]
    return [(other, j) for j in range(R)]


def _create_subgroups(mesh: Mesh) -> None:
    """One gloo subgroup for each collective group whose members span
    processes, every group in the same order in every process:
    ``dist.new_group`` is collective over the whole world."""
    import datetime

    import torch.distributed as dist

    from spark_bagging_tpu_torch.parallel import distributed

    timeout = datetime.timedelta(seconds=distributed.group_timeout_s())
    D, R = mesh.devices.shape
    for axis, n_other in ((DATA_AXIS, R), (REPLICA_AXIS, D)):
        for other in range(n_other):
            procs = sorted({int(mesh.processes[ix])
                            for ix in group_members(mesh, axis, other)})
            if len(procs) > 1:
                mesh.subgroups[(axis, other)] = dist.new_group(
                    ranks=procs, timeout=timeout, backend="gloo")


def device_put_rows(X, mesh: Mesh) -> list[torch.Tensor]:
    """Host matrix -> one row block per data shard, each on its shard's
    devices (replicated over ``replica``): the placement step of a data
    mesh, returned as ``[[block on (i, j) for j] for i]`` (None at a
    position another process owns). Row count must be divisible by the
    data-axis size (``pad_rows`` / ``pad_rows_X`` first)."""
    if X.shape[0] % mesh.shape[DATA_AXIS] != 0:
        raise ValueError(
            f"{X.shape[0]} rows not divisible by data-axis size "
            f"{mesh.shape[DATA_AXIS]}; pad rows first"
        )
    Xt = torch.as_tensor(np.asarray(X, np.float32)
                         if not isinstance(X, torch.Tensor) else X)
    blocks = torch.chunk(Xt, mesh.shape[DATA_AXIS], dim=0)
    return [[blk.to(mesh.device(i, j)) if mesh.is_local((i, j)) else None
             for j in range(mesh.shape[REPLICA_AXIS])]
            for i, blk in enumerate(blocks)]
