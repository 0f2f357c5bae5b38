"""An in-process ``shard_map``: one thread a mesh position, JAX's
collective semantics.

The port of the JAX package's ``parallel/compat.py``. Torch has no
``shard_map``, so this module is one: ``shard_map(f, mesh=, in_specs=,
out_specs=)`` returns a function that splits its arguments over the
mesh, runs ``f`` once per mesh position — each on its own thread, under
``torch.cuda.device(dev)`` for a CUDA device — and assembles the
outputs. Each thread has a shard context with its axis indices and one
collective group per axis, which the collectives read:

- :func:`axis_index` — this shard's index along an axis;
- :func:`psum` — the sum over an axis. Every member's tensor goes to
  the group's first device and is summed left to right in shard order,
  and the sum is copied back to each member's device, so a rerun is
  bitwise the same;
- :func:`all_gather` — the members' tensors concatenated along axis 0
  in shard order (``tiled=True``).

Specs use JAX's ``P(...)`` spelling (:class:`PartitionSpec`, also
exported as ``P``): ``P(REPLICA_AXIS)`` splits (and concatenates) the
leading axis in replica order, ``P(DATA_AXIS, ...)`` the rows in data
order, ``P()`` replicates an input and takes shard 0's output. A spec
applies to every tensor of its argument's tree (dicts, tuples, lists).

A body that raises aborts every group's barrier, so its siblings stop
at their next collective rather than hang; the first error is raised in
the caller, and every wait has a timeout (``COLLECTIVE_TIMEOUT_S``).

:func:`count_launch` is the kernel wrappers' launch counter: a launch
counts under one lock (the shards launch from several threads), once in
the wrapper's total and once under the shard it ran in.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from spark_bagging_tpu_torch.parallel.mesh import DATA_AXIS, REPLICA_AXIS, Mesh

HAS_SHARD_MAP: bool = True
SHARD_MAP_SOURCE: str = "spark_bagging_tpu_torch.parallel.compat"

#: seconds a shard waits at one collective before the call fails
COLLECTIVE_TIMEOUT_S = 600.0


class ShardMapUnavailable(NotImplementedError):
    """JAX's surface: raised where no ``shard_map`` exists (never here —
    the port's runner is always available)."""


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per tensor axis, an axis name
    or None. Only the first entry splits."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class _Group:
    """One collective group: the members of one axis at fixed other
    coordinates. Exchanges go through generation-indexed slots."""

    def __init__(self, members: list[tuple[int, int]], devices: list):
        self.members = members
        self.devices = devices
        self.barrier = threading.Barrier(len(members))
        self.slots: dict[tuple[int, int], Any] = {}
        self.results: dict[int, Any] = {}
        self.lock = threading.Lock()

    def exchange(self, pos: int, gen: int, value, combine):
        """Every member hands in ``value``; member 0 runs ``combine`` over
        the values in shard order once they are all in, and every member
        gets its result."""
        with self.lock:
            self.slots[(gen, pos)] = value
        self.barrier.wait(COLLECTIVE_TIMEOUT_S)
        if pos == 0:
            vals = [self.slots.pop((gen, k)) for k in range(len(self.members))]
            self.results[gen] = combine(vals)
            # every member has read the previous generation's result
            # before handing in this generation's value
            self.results.pop(gen - 1, None)
        self.barrier.wait(COLLECTIVE_TIMEOUT_S)
        return self.results[gen]


class _ShardContext:
    """What one shard's thread knows: its mesh position, its groups and
    how many collectives it made on each."""

    def __init__(self, mesh: Mesh, index: tuple[int, int],
                 groups: dict[str, _Group]):
        self.mesh = mesh
        self.index = index
        self.groups = groups
        self.gens = {name: 0 for name in groups}
        self.device = mesh.device(*index)

    def position(self, axis: str) -> int:
        return self.index[0] if axis == DATA_AXIS else self.index[1]


_tls = threading.local()


def current() -> _ShardContext | None:
    """This thread's shard context, or None outside a ``shard_map``."""
    return getattr(_tls, "ctx", None)


def current_shard() -> tuple[int, int] | None:
    """This thread's ``(data, replica)`` mesh position, or None."""
    ctx = current()
    return None if ctx is None else ctx.index


def _context(axis: str) -> _ShardContext:
    ctx = current()
    if ctx is None:
        raise RuntimeError(
            f"collective over {axis!r} outside a shard_map body")
    if axis not in ctx.groups:
        raise ValueError(
            f"unknown mesh axis {axis!r} (axes: {DATA_AXIS!r}, "
            f"{REPLICA_AXIS!r})")
    return ctx


def axis_index(axis: str) -> int:
    """This shard's index along ``axis``."""
    return _context(axis).position(axis)


def _collective(axis: str, value, combine):
    ctx = _context(axis)
    group = ctx.groups[axis]
    gen = ctx.gens[axis]
    ctx.gens[axis] = gen + 1
    pos = ctx.position(axis)
    out = group.exchange(pos, gen, value, combine)
    # member 0 keeps the combined tensor; the others take copies, so no
    # member's in-place update can reach another's
    return out if pos == 0 else out.to(ctx.device, copy=True)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, in shard order on the group's
    first device; every member gets it on its own device."""
    ctx = _context(axis)
    first = ctx.groups[axis].devices[0]

    def combine(vals):
        acc = vals[0].to(first)
        for v in vals[1:]:
            acc = acc + v.to(first)
        return acc

    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=ctx.device)
    return _collective(axis, x, combine)


def all_gather(x: torch.Tensor, axis: str, *, tiled: bool = True) -> torch.Tensor:
    """The members' ``x`` along ``axis``: concatenated on axis 0 in shard
    order (``tiled=True``) or stacked on a new leading axis."""
    ctx = _context(axis)
    first = ctx.groups[axis].devices[0]

    def combine(vals):
        vals = [v.to(first) for v in vals]
        return torch.cat(vals, dim=0) if tiled else torch.stack(vals)

    return _collective(axis, x, combine)


# -- launch counting ---------------------------------------------------

_count_lock = threading.Lock()


def count_launch(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to the kernel wrapper ``fn``'s counter ``attr`` under one
    lock; inside a shard also to ``fn.shard_launches[(attr, shard)]``."""
    shard = current_shard()
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)
        if shard is not None:
            per = fn.__dict__.setdefault("shard_launches", {})
            per[(attr, shard)] = per.get((attr, shard), 0) + n


# -- splitting and assembling trees ------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, PartitionSpec):
        return tuple(_tree_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _split_axis(spec) -> str | None:
    if spec is None or len(spec) == 0:
        return None
    return spec[0]


def _take(leaf, axis: str | None, index: tuple[int, int], mesh: Mesh,
          device: torch.device):
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if axis is None:
        return leaf.to(device)
    k = index[0] if axis == DATA_AXIS else index[1]
    size = mesh.shape[axis]
    n = leaf.shape[0]
    if n % size != 0:
        raise ValueError(
            f"leading size {n} not divisible by the {axis!r} axis size "
            f"{size}")
    step = n // size
    return leaf[k * step:(k + 1) * step].to(device)


def _assemble(outs: dict, spec, mesh: Mesh):
    """One output tree from every shard's: concatenated over the spec's
    axis in shard order (taking index 0 of the other axis), or shard
    (0, 0)'s for ``P()``."""
    axis = _split_axis(spec)
    D, R = mesh.shape[DATA_AXIS], mesh.shape[REPLICA_AXIS]
    first = mesh.first_device
    if axis is None:
        order = [(0, 0)]
    elif axis == DATA_AXIS:
        order = [(i, 0) for i in range(D)]
    else:
        order = [(0, j) for j in range(R)]
    parts = [outs[ix] for ix in order]

    def join(*leaves):
        if not isinstance(leaves[0], torch.Tensor):
            return leaves[0]
        if len(leaves) == 1:
            return leaves[0].to(first)
        return torch.cat([v.to(first) for v in leaves], dim=0)

    return _zip_map(join, parts)


def _zip_map(fn, trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        out = [_zip_map(fn, [t[i] for t in trees]) for i in range(len(first))]
        return tuple(out) if isinstance(first, tuple) else out
    return fn(*trees)


_ready_lock = threading.Lock()
_ready_devices: set = set()


def _ready_cuda(devices) -> None:
    """Load each CUDA device's lazily loaded libraries (cuSOLVER and the
    linear-algebra module) from the calling thread, once: their loader
    is not thread-safe, and the shards' first Cholesky or solve would
    race on it."""
    with _ready_lock:
        for dev in devices:
            if dev.type != "cuda" or dev in _ready_devices:
                continue
            with torch.cuda.device(dev):
                eye = torch.eye(2, device=dev)
                torch.linalg.cholesky_ex(eye)
                torch.linalg.solve_ex(eye, eye)
            _ready_devices.add(dev)


def shard_map(f: Callable, *, mesh: Mesh, in_specs, out_specs,
              check_vma: bool = True) -> Callable:
    """``jax.shard_map``'s surface over the in-process runner (see the
    module docstring). ``check_vma`` is accepted and has no effect."""
    del check_vma
    if not isinstance(in_specs, tuple) or isinstance(in_specs, PartitionSpec):
        in_specs = (in_specs,)
    single_out = isinstance(out_specs, PartitionSpec)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(
                f"shard_map body takes {len(in_specs)} arguments, got "
                f"{len(args)}")
        D, R = mesh.shape[DATA_AXIS], mesh.shape[REPLICA_AXIS]
        index_list = [(i, j) for i in range(D) for j in range(R)]
        data_groups = {
            j: _Group([(i, j) for i in range(D)],
                      [mesh.device(i, j) for i in range(D)])
            for j in range(R)}
        replica_groups = {
            i: _Group([(i, j) for j in range(R)],
                      [mesh.device(i, j) for j in range(R)])
            for i in range(D)}
        _ready_cuda(set(mesh.devices.ravel().tolist()))
        outs: dict[tuple[int, int], Any] = {}
        errors: list[tuple[tuple[int, int], BaseException]] = []
        err_lock = threading.Lock()
        all_groups = [*data_groups.values(), *replica_groups.values()]

        def body(index):
            dev = mesh.device(*index)
            ctx = _ShardContext(mesh, index, {
                DATA_AXIS: data_groups[index[1]],
                REPLICA_AXIS: replica_groups[index[0]],
            })
            _tls.ctx = ctx
            try:
                shard_args = [
                    _tree_map(lambda leaf, s=spec: _take(
                        leaf, _split_axis(s), index, mesh, dev), a)
                    for a, spec in zip(args, in_specs)]
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        outs[index] = f(*shard_args)
                        # the shard's queued work is done before its
                        # outputs are read from another thread
                        torch.cuda.current_stream(dev).synchronize()
                else:
                    outs[index] = f(*shard_args)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                with err_lock:
                    errors.append((index, e))
                for g in all_groups:
                    g.barrier.abort()
            finally:
                _tls.ctx = None

        threads = [threading.Thread(target=body, args=(ix,),
                                    name=f"shard{ix}", daemon=True)
                   for ix in index_list]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # the first error that is not a sibling's broken barrier
            real = [e for _, e in errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            index, err = next(((ix, e) for ix, e in errors if e in real),
                              errors[0])
            if isinstance(err, threading.BrokenBarrierError):
                raise TimeoutError(
                    f"shard {index} timed out at a collective after "
                    f"{COLLECTIVE_TIMEOUT_S} s") from err
            raise err
        if single_out:
            return _assemble(outs, out_specs, mesh)
        return tuple(
            _assemble({ix: outs[ix][k] for ix in index_list}, spec, mesh)
            for k, spec in enumerate(out_specs))

    return run
