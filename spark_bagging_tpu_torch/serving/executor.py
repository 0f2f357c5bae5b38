"""Shape-bucketed executor for one fitted ensemble, one CUDA graph a bucket.

The batch API (``BaggingClassifier.predict_proba`` &c.) launches the
ensemble forward kernel by kernel on every call — fine for offline
scoring, wrong for online traffic, where the host's launch cost per
request is the latency. ``EnsembleExecutor`` turns a fitted estimator
into a long-lived predictor:

- the aggregated forward (``model.aggregated_forward()``) is captured
  ONCE per row bucket as a ``torch.cuda.CUDAGraph`` that reads a static
  ``(bucket, d)`` float32 input buffer and writes a static output
  buffer; serving a slab is then one host copy into a pinned staging
  buffer, one copy to the card, one graph replay and one copy back.
  The capture is the torch analogue of the JAX package's AOT compile
  per bucket: warm-up runs on a side stream first, and every bucket of
  one executor warms up and captures on that one stream, into one
  shared graph memory pool;
- incoming batches pad up to the power-of-two bucket ladder
  (``buckets.py``), so the set of programs is finite and :meth:`warmup`
  makes post-warmup builds exactly zero (``sbt_serving_compiles_total``
  counts every build: on CUDA a build is one graph capture);
- batches larger than the top bucket split into top-bucket slabs.

The quality plane's disagreement tap (``telemetry/quality.py``) has
programs of its own: the per-replica forward (``model.replica_forward()``)
captured once per bucket in the same way, into the same graph pool,
with its own static buffers, counted in
``sbt_quality_disagreement_compiles_total`` and never in the serving
counter. A sampled batch replays it on the host rows of the slab just
served (never on the serving graph's static input, which the next
batch overwrites); an unsampled batch feeds the monitor host arrays
only and adds no device synchronization.

Each bucket's build also counts its forward's cost (``bucket_costs``):
the matrix-product FLOPs of one eager call at the bucket's shape,
counted by ``torch.utils.flop_counter.FlopCounterMode`` before and
outside the capture (``flops`` is None for a forward with no counted
product, such as the trees', and attribution falls back to rows), and
the bytes of every input read once (parameters, subspaces, the slab)
plus the output written once — once per executor and bucket: a
re-capture after :meth:`EnsembleExecutor.release_programs` (a tenant's
restore) reuses the counted cost, since neither the weights nor the
shape changed. They feed ``sbt_serving_bucket_cost_*``,
``sbt_serving_flops_total`` / ``sbt_serving_padding_flops_total`` and
the performance plane's cost model.

On a CPU model (the parity tests) a bucket's program is the eager
forward at the bucket's shape, built (and counted) once per bucket in
the same way, so the counters' contract is the same on both devices.
The device is the model's: a CUDA model whose capture fails raises; it
is never served eagerly.

Thread-safety: a graph with static buffers is not reentrant, so each
bucket program holds a lock over copy-in, replay and copy-out, and
returns outputs the next replay cannot overwrite. The static outputs
are allocated outside the graph pool, so buckets that share the pool
may replay in any order. Programs are built under the executor's build
lock (one build per bucket even when many threads race to first use).

The capacity plane's demand tap (``telemetry/capacity.py``) and the
performance plane's forward probe (``telemetry/perf.py``) cost one
module-attribute read each while no plane is installed.

``mesh`` (a replica mesh, ``parallel.make_mesh(replica=k)``) serves
the ensemble's replicas sharded over the mesh (``parallel/sharded.
replica_sharded_serving``): a bucket's program (:class:`MeshProgram`)
is one program a shard — a CUDA graph a (bucket, shard) on the card —
run in shard order from the dispatching thread (a capture must not race
another on one device, and a replica-only forward has no collective
mid-body), then the per-replica outputs are gathered on the first
shard's device and reduced by the single-device forward's own
operations, so every bucket serves the single-device executor's bits.
A shard that fails (``faults.ShardFault``, or :meth:`degrade_shards`)
leaves the quorum: the executor then serves the surviving replicas'
aggregate (``replica_subset_serving``), bitwise the subset aggregate
recomputed offline, until :meth:`reset_degraded`.

A CUDA graph cannot be serialized, so there is no persisted executable
cache: :meth:`restore_executables` ignores one.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from spark_bagging_tpu_torch import faults, telemetry
from spark_bagging_tpu_torch.analysis.locks import make_lock
from spark_bagging_tpu_torch.serving import program_cache as _pc
from spark_bagging_tpu_torch.serving.buckets import (
    DEFAULT_MAX_ROWS,
    DEFAULT_MIN_ROWS,
    bucket_for,
    bucket_ladder,
    pack_plan,
)
from spark_bagging_tpu_torch.telemetry import capacity as _capacity
from spark_bagging_tpu_torch.telemetry import perf as _perf
from spark_bagging_tpu_torch.telemetry import tracing

#: eager runs on a side stream before a capture (cuBLAS handles,
#: workspaces and the allocator's blocks settle outside the graph); a
#: re-capture of a bucket this executor already captured (a tenant's
#: restore) runs one, which sizes the static output
CAPTURE_WARMUP_ITERS = 2


def counted_forward(fn, params, subspaces, x):
    """One eager call of the forward with its cost: ``(out, {"flops",
    "bytes"})``. ``flops`` counts the call's matrix products
    (``FlopCounterMode``: 2·m·n·k a product, elementwise work not
    counted), None when there is none; ``bytes`` is every input read
    once and the output written once. Never call it inside a capture."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(params, subspaces, x)
    flops = counter.get_total_flops()
    nbytes = _pc.tree_nbytes((params, subspaces, x, out))
    return out, {"flops": float(flops) if flops > 0 else None,
                 "bytes": float(nbytes)}


class EagerProgram:
    """A CPU bucket program: the forward run eagerly at the bucket's
    shape. Reentrant (every call allocates its own output). ``row_axis``
    is the output's row axis: 0 for the aggregated forward, 1 for the
    per-replica ``(R, n, ...)`` one."""

    nbytes = None

    def __init__(self, fn, params, subspaces, bucket: int, n_features: int,
                 row_axis: int = 0, cost: dict | None = None):
        self._fn, self._params, self._subspaces = fn, params, subspaces
        self.row_axis = row_axis
        # the build runs the forward once, as a capture's warm-up does,
        # and counts its cost unless it is already known
        x = torch.zeros((bucket, n_features), dtype=torch.float32)
        if cost is None:
            _, cost = counted_forward(fn, params, subspaces, x)
        else:
            fn(params, subspaces, x)
        self.cost = cost

    def run(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        X = (torch.from_numpy(Xp) if Xp.flags.writeable
             else torch.tensor(Xp))
        out = self._fn(self._params, self._subspaces, X).numpy()
        return out[:fill] if self.row_axis == 0 else out[:, :fill]


def pool_reserved_bytes(pool) -> int:
    """Bytes the caching allocator holds in the segments of the graph
    memory pool ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == pool)


class GraphProgram:
    """A CUDA bucket program: one captured graph over a static input
    and a static output buffer, fed from a pinned staging buffer.

    The graph replays against the device addresses it captured, so the
    program keeps the forward, its parameters and its subspaces alive
    for as long as it lives: an executor that adopts it from the program
    cache never replays against a retired model's freed memory.

    ``nbytes`` is the device memory the program holds: its static
    buffers plus the segments the capture added to the executor's graph
    pool (read from the allocator's snapshot, so other pools and other
    threads' allocations are not counted). The cuBLAS workspace of the
    capture stream, made at the first warm-up, is the stream's and not
    counted.

    ``row_axis`` is the output's row axis: 0 for the aggregated forward
    (only the real rows come back), 1 for the per-replica ``(R, n, ...)``
    forward of the disagreement tap (the whole static output comes back
    in one contiguous copy and the real rows are sliced on the host).

    ``cost`` is the forward's cost at this bucket (:func:`counted_forward`),
    counted on the first warm-up call, before and outside the capture —
    or passed in when the executor already counted it.
    """

    def __init__(self, fn, params, subspaces, bucket: int, n_features: int,
                 pool, stream, row_axis: int = 0, cost: dict | None = None):
        device = subspaces.device
        self._fn, self._params, self._subspaces = fn, params, subspaces
        self.row_axis = row_axis
        self.lock = threading.Lock()
        x = torch.zeros((bucket, n_features), dtype=torch.float32,
                        device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            if cost is None:
                warm, cost = counted_forward(fn, params, subspaces, x)
                for _ in range(CAPTURE_WARMUP_ITERS - 1):
                    warm = fn(params, subspaces, x)
            else:
                warm = fn(params, subspaces, x)
        self.cost = cost
        torch.cuda.current_stream(device).wait_stream(stream)
        # the static output lives outside the pool: a replay of another
        # bucket's graph that reuses this graph's pool blocks can never
        # overwrite it
        out = torch.empty_like(warm)
        del warm
        pool0 = pool_reserved_bytes(pool)
        graph = torch.cuda.CUDAGraph()
        # thread-local capture: a swap captures its replacement while
        # other threads replay the live graphs and copy requests in; only
        # this thread's host syncs may invalidate the capture (the
        # capture stream is non-blocking, so their default-stream work
        # never joins it). The capture is begun and ended directly, not
        # through ``torch.cuda.graph``, whose entry synchronizes the
        # device and empties the device and pinned-host caches before
        # every capture: a restore re-captures a whole ladder, and each
        # of those frees came back as fresh allocations for the next
        # capture (and a device-wide wait on the other threads' replays)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out.copy_(fn(params, subspaces, x))
            finally:
                graph.capture_end()
        torch.cuda.synchronize(device)
        # a live graph's pool segments are never released, so the growth
        # is the capture's own and not negative
        self.nbytes = (pool_reserved_bytes(pool) - pool0
                       + x.nbytes + out.nbytes)
        self.graph, self.x, self.out = graph, x, out
        self.x_host = torch.empty((bucket, n_features), dtype=torch.float32,
                                  pin_memory=True)
        self.out_host = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
        self._x_np = self.x_host.numpy()
        self._out_np = self.out_host.numpy()
        self.done = torch.cuda.Event()

    def run(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        with self.lock:
            self._x_np[...] = Xp
            self.x.copy_(self.x_host, non_blocking=True)
            self.graph.replay()
            if self.row_axis == 0:
                self.out_host[:fill].copy_(self.out[:fill],
                                           non_blocking=True)
                out = self._out_np[:fill]
            else:
                self.out_host.copy_(self.out, non_blocking=True)
                out = self._out_np[:, :fill]
            self.done.record()
            self.done.synchronize()
            return out.copy()


class MeshProgram:
    """A replica-sharded bucket program over ``fwd`` (a
    ``parallel.sharded.ShardedForward``): one program a shard on its
    device — a captured graph on the card (:class:`GraphProgram`), the
    eager per-replica forward on the CPU — run in shard order, the
    shards' outputs gathered on the first shard's device in replica
    order and reduced by ``fwd.reduce`` (``row_axis`` 0), or returned
    per replica (``row_axis`` 1: the disagreement tap's program).

    ``nbytes`` sums the shards' graph bytes (None on the CPU); ``cost``
    is the whole forward's, counted once at the build on the first
    shard's device, before and outside any capture."""

    def __init__(self, fwd, shard_params, shard_subs, bucket: int,
                 n_features: int, pool_for, row_axis: int = 0,
                 cost: dict | None = None):
        self._fwd = fwd
        self._params, self._subs = shard_params, shard_subs
        self.row_axis = row_axis
        self.lock = threading.Lock()
        first = fwd.devices[0]
        if cost is None:
            x = torch.zeros((bucket, n_features), dtype=torch.float32,
                            device=first)
            _, cost = counted_forward(fwd, shard_params, shard_subs, x)
        self.cost = cost
        self._cuda = first.type == "cuda"
        self.nbytes = None
        if not self._cuda:
            return
        self._shards = []
        for p, sub, dev in zip(shard_params, shard_subs, fwd.devices):
            pool, stream = pool_for(dev)
            with torch.cuda.device(dev):
                self._shards.append(GraphProgram(
                    fwd.rep_fn, p, sub, bucket, n_features, pool, stream,
                    row_axis=1, cost=cost))
        self.nbytes = sum(g.nbytes for g in self._shards)
        self.x_host = torch.empty((bucket, n_features), dtype=torch.float32,
                                  pin_memory=True)
        self._x_np = self.x_host.numpy()
        self.done = torch.cuda.Event()

    def run(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        if not self._cuda:
            X = (torch.from_numpy(Xp) if Xp.flags.writeable
                 else torch.tensor(Xp))
            out = self._fwd(self._params, self._subs, X).numpy()
            return out[:fill] if self.row_axis == 0 else out[:, :fill]
        with self.lock:
            self._x_np[...] = Xp
            for g, dev in zip(self._shards, self._fwd.devices):
                with torch.cuda.device(dev):
                    g.x.copy_(self.x_host, non_blocking=True)
                    g.graph.replay()
            full = self._fwd.gather([g.out for g in self._shards])
            if self.row_axis == 0:
                out = self._fwd.reduce(full)[:fill]
            else:
                out = full[:, :fill]
            host = out.to("cpu", non_blocking=True)
            self.done.record()
            self.done.synchronize()
            return host.numpy().copy()


# sbt-lint: shared-state
class EnsembleExecutor:
    """Serve one fitted bagging estimator with one program a bucket.

    ``model`` is any fitted ``Bagging*``/``RandomForest*`` estimator of
    the port (or anything exposing the same ``aggregated_forward()``
    contract, with ``task`` and ``n_features_in_``). The device is the
    model's parameters' device.

    ``donate_input`` is accepted so that the registry's
    ``serve_config.json`` (which carries it, as the JAX package's does)
    reads back; a torch program has no buffer donation, so it changes
    nothing and is not part of the program key.
    ``mesh`` switches the executor to the replica-sharded serving
    program (module docstring): a data-axis size of 1 and a replica
    axis that divides ``n_estimators``; everything else — the bucket
    ladder, ragged packing, the batcher seam, the quality tap — is
    unchanged.
    """

    def __init__(
        self,
        model: Any,
        *,
        min_bucket_rows: int = DEFAULT_MIN_ROWS,
        max_batch_rows: int = DEFAULT_MAX_ROWS,
        donate_input: bool | None = None,
        mesh: Any = None,
    ):
        if min_bucket_rows < 1 or max_batch_rows < min_bucket_rows:
            raise ValueError(
                f"need 1 <= min_bucket_rows <= max_batch_rows, got "
                f"{min_bucket_rows}, {max_batch_rows}"
            )
        self.mesh = mesh
        self.mesh_shape = _pc.mesh_shape(mesh)
        self._n_shards: int | None = None
        rep_fwd = None
        if mesh is None:
            fn, params, subspaces = model.aggregated_forward()
            device = subspaces.device
        else:
            from spark_bagging_tpu_torch.parallel.sharded import (
                replica_sharded_serving,
            )

            (fn, rep_fwd, params, subspaces, device,
             n_shards) = replica_sharded_serving(model, mesh)
            self._n_shards = int(n_shards)
            telemetry.set_gauge("sbt_serving_shard_devices",
                                float(n_shards))
        # degraded-quorum state (mesh executors only): shards marked
        # failed, and the surviving replica indices the degraded
        # aggregate averages over (None while healthy)
        self._failed_shards: set[int] = set()
        self._survivors: tuple[int, ...] | None = None
        self.model = model
        self.task: str = model.task
        self.n_features: int = int(model.n_features_in_)
        self.classes_ = getattr(model, "classes_", None)
        self.min_bucket_rows = int(min_bucket_rows)
        self.max_batch_rows = int(max_batch_rows)
        self.device: torch.device = device
        self._fn = fn
        self._params = params
        self._subspaces = subspaces
        del donate_input  # inert: see the class docstring
        # program identity for the unified program cache: computed ONCE
        # per executor (it reads every parameter byte)
        try:
            self.fingerprint: str = _pc.fingerprint_model(model)
        except AttributeError:
            self.fingerprint = _pc.fingerprint_params(
                type(model), self.task, self.n_features, self.classes_,
                params, subspaces,
            )
        self._variant = _pc.forward_variant(model)
        self._replica_variant = _pc.forward_variant(model, "replica")
        self._toolchain = _pc.toolchain_id(self.device)
        self._compiled: dict[int, Any] = {}
        # bucket -> {"flops", "bytes"} of one forward, counted at the
        # bucket's build (flops None when the forward runs no counted
        # product): the denominator that turns padding waste from rows
        # into FLOPs, and the performance plane's cost model
        self.bucket_costs: dict[int, dict[str, float | None]] = {}
        # (row axis, bucket) -> that cost, kept across release_programs:
        # a re-capture reuses it instead of counting again
        self._counted: dict[tuple[int, int], dict] = {}
        # the disagreement tap's per-replica programs, one a bucket,
        # built on first need (warmup_replica, or a sampled batch)
        self._replica_compiled: dict[int, Any] = {}
        self._replica_fn = rep_fwd
        self._replica_unavailable = False
        # the attached quality monitor (telemetry/quality.py), or None:
        # the serving path's whole cost without one is this one read
        self._quality = None
        self._quality_warned = False
        self._build_lock = make_lock("serving.executor.build")
        # every bucket of this executor warms up and captures on one side
        # stream, into one graph pool: cuBLAS keeps a workspace for each
        # stream it runs on, so a stream a capture would cost one each
        self._pool = self._stream = None
        # a mesh shard on another card captures into that card's pool
        self._shard_pools: dict[torch.device, tuple] = {}
        if self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        # stamped by ModelRegistry on register/swap; standalone
        # executors serve as anonymous version None
        self.model_name: str | None = None
        self.model_version: int | None = None

    # -- program management --------------------------------------------

    @property
    def compiled_buckets(self) -> tuple[int, ...]:
        """Buckets with a live program (ascending)."""
        return tuple(sorted(self._compiled))

    @property
    def graph_pool_bytes(self) -> int:
        """Device bytes this executor's bucket programs reserved at
        their builds, the disagreement tap's included (0 on the CPU)."""
        progs = [*self._compiled.values(), *self._replica_compiled.values()]
        return sum(p.nbytes or 0 for p in progs)

    @property
    def replica_buckets(self) -> tuple[int, ...]:
        """Buckets with a live per-replica (disagreement-tap) program."""
        return tuple(sorted(self._replica_compiled))

    def replica_program(self, bucket: int):
        """The live per-replica program of ``bucket`` (None before its
        build) — tests compare its replay with the eager closure."""
        return self._replica_compiled.get(int(bucket))

    def program(self, bucket: int):
        """The live program of ``bucket`` (None before its build) —
        tests compare its replay with the eager closure."""
        return self._compiled.get(int(bucket))

    def warmup(self, buckets=None) -> tuple[int, ...]:
        """Build ahead of traffic. ``buckets=None`` covers the full
        ladder — afterwards NO request can trigger a build. Returns the
        buckets this call installed (built, or adopted from the unified
        program cache when another executor of this model already paid
        the capture)."""
        if buckets is None:
            buckets = bucket_ladder(self.min_bucket_rows,
                                    self.max_batch_rows)
        built = []
        for b in buckets:
            b = bucket_for(int(b), self.min_bucket_rows,
                           self.max_batch_rows)
            if b not in self._compiled:
                self._build(b)
                built.append(b)
        return tuple(built)

    def _program_key(self, bucket: int,
                     variant: str | None = None) -> _pc.ProgramKey:
        return _pc.ProgramKey(
            self.fingerprint, variant or self._variant, int(bucket),
            self.mesh_shape, *self._toolchain,
        )

    def _pool_for(self, dev: torch.device) -> tuple:
        """The graph pool and capture stream of ``dev`` (the caller holds
        the build lock)."""
        if dev == self.device:
            return self._pool, self._stream
        if dev not in self._shard_pools:
            with torch.cuda.device(dev):
                # sbt-lint: disable=shared-state-unlocked — every caller holds self._build_lock
                self._shard_pools[dev] = (torch.cuda.graph_pool_handle(),
                                          torch.cuda.Stream(dev))
        return self._shard_pools[dev]

    def _new_program(self, bucket: int, fn=None, row_axis: int = 0):
        """Build one program (the caller holds the build lock)."""
        from spark_bagging_tpu_torch.parallel.sharded import ShardedForward

        fn = self._fn if fn is None else fn
        key = (row_axis, bucket)
        if isinstance(fn, ShardedForward):
            prog = MeshProgram(fn, self._params, self._subspaces, bucket,
                               self.n_features, self._pool_for, row_axis,
                               self._counted.get(key))
        elif self._subspaces.device.type != "cuda":
            prog = EagerProgram(fn, self._params, self._subspaces, bucket,
                                self.n_features, row_axis,
                                self._counted.get(key))
        else:
            try:
                prog = GraphProgram(fn, self._params, self._subspaces,
                                    bucket, self.n_features, self._pool,
                                    self._stream, row_axis,
                                    self._counted.get(key))
            except Exception as e:
                what = "forward" if row_axis == 0 else "per-replica forward"
                raise RuntimeError(
                    f"CUDA-graph capture of the {what} at bucket {bucket} "
                    f"failed ({e!r}); a CUDA model is never served "
                    "eagerly — the forward must not synchronize with the "
                    "host or size its allocations from values it reads on "
                    "the card"
                ) from e
        # sbt-lint: disable=shared-state-unlocked — every caller holds self._build_lock
        self._counted[key] = prog.cost
        return prog

    def _build(self, bucket: int):
        """Install the program for one bucket: a unified-cache hit adopts
        the already-built program (a capture another executor of this
        model already paid); only a miss builds, counting
        ``sbt_serving_compiles_total``. Serialized + double-checked so
        racing threads resolve each bucket once."""
        with self._build_lock:
            prog = self._compiled.get(bucket)
            if prog is not None:
                return prog
            key = self._program_key(bucket)
            prog = _pc.cache().get(key)
            # a card executor never serves a batch predict's eager
            # program: it captures its graph in that entry's place
            eager_batch = (isinstance(prog, _pc.EagerBatchProgram)
                           and self.device.type == "cuda")
            if prog is not None and not eager_batch:
                self._install(bucket, prog)
                return prog
            t0 = time.perf_counter()
            with telemetry.span("serving_compile", bucket=bucket):
                prog = self._new_program(bucket)
            if self._failed_shards:
                # a degraded program's build is the fault's cost, not a
                # serving build: the zero-post-warmup gate stays whole
                telemetry.inc("sbt_serving_degraded_compiles_total")
            else:
                telemetry.inc("sbt_serving_compiles_total")
                if self.model_name is not None:
                    # labeled twin: per-model build attribution
                    telemetry.inc("sbt_serving_compiles_total",
                                  labels={"model": str(self.model_name)})
            if self.mesh is not None and not self._failed_shards:
                telemetry.inc(
                    "sbt_shardmap_traces_total",
                    labels={"kind": "serving",
                            "mesh": "x".join(map(str, self.mesh_shape))},
                )
            telemetry.observe("sbt_serving_compile_seconds",
                              time.perf_counter() - t0)
            prog = (_pc.cache().put(key, prog, replace=True) if eager_batch
                    else _pc.cache().put(key, prog))
            self._install(bucket, prog)
            self._export_pool_bytes()
            return prog

    def _install(self, bucket: int, prog) -> None:
        """Record one bucket program and its cost gauges (the caller
        holds the build lock)."""
        cost = prog.cost
        # sbt-lint: disable=shared-state-unlocked — every caller holds self._build_lock (_build)
        self.bucket_costs[bucket] = cost
        if telemetry.enabled():
            labels = {"bucket": str(bucket)}
            if cost["flops"] is not None:
                telemetry.set_gauge("sbt_serving_bucket_cost_flops",
                                    cost["flops"], labels=labels)
            telemetry.set_gauge("sbt_serving_bucket_cost_bytes",
                                cost["bytes"], labels=labels)
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (see docstring)
        self._compiled[bucket] = prog

    def _export_pool_bytes(self) -> None:
        if self.device.type == "cuda" and self.model_name is not None:
            telemetry.set_gauge("sbt_serving_graph_pool_bytes",
                                float(self.graph_pool_bytes),
                                labels={"model": str(self.model_name)})

    def restore_executables(self, path: str) -> tuple[int, ...]:
        """Ignore a persisted executable cache (the JAX package's
        ``serving_aot/``): counted as one miss in
        ``sbt_serving_aot_misses_total``; the live buckets are captured
        at warm-up instead. Returns ``()``."""
        del path
        telemetry.inc("sbt_serving_aot_misses_total")
        return ()

    def release_programs(self) -> tuple[int, ...]:
        """Drop every bucket program — the tenant-demotion seam
        (``tenancy/residency.py``). The unified cache drops this
        fingerprint's entries (charged through the capacity plane's
        eviction seam) while the executor still holds the programs, so
        the weak entries are alive to be counted; then the in-instance
        ladder and the disagreement tap's programs are cleared, and the
        captures (and their pool segments) free once no other executor
        holds them. The pool's segments go back to the caching
        allocator; the device's reserved bytes fall only at
        ``torch.cuda.empty_cache()``. Later captures go to a fresh graph
        pool (the allocator refuses a capture into a private pool whose
        last graph died). The executor stays serveable — the next
        request, or :meth:`warmup`, builds on demand. Returns the
        buckets released."""
        with self._build_lock:
            released = tuple(sorted(self._compiled))
            _pc.cache().drop_fingerprint(self.fingerprint)
            self._compiled.clear()
            self._replica_compiled.clear()
            self.bucket_costs.clear()
            if self._pool is not None:
                self._pool = torch.cuda.graph_pool_handle()
            self._shard_pools.clear()
        if released:
            telemetry.inc("sbt_serving_programs_released_total",
                          float(len(released)))
        self._export_pool_bytes()
        return released

    # -- degraded-quorum serving (mesh executors) ----------------------

    @property
    def degraded(self) -> bool:
        """True when this executor serves the surviving-replica
        aggregate after one or more mesh shards failed."""
        return bool(self._failed_shards)

    @property
    def failed_shards(self) -> tuple[int, ...]:
        return tuple(sorted(self._failed_shards))

    @property
    def surviving_replicas(self) -> int | None:
        """How many replicas the (degraded) aggregate averages over —
        None while healthy (every replica serves)."""
        return len(self._survivors) if self._survivors is not None else None

    def degrade_shards(self, shards) -> None:
        """Drop mesh shards from the serving quorum by hand (what a
        ``faults.ShardFault`` does on its own). Mesh executors only."""
        if self.mesh is None:
            raise ValueError(
                "degrade_shards is mesh-serving only; a single-device "
                "executor has no shards to lose"
            )
        for s in shards:
            self._degrade_shard(int(s))

    def _degrade_shard(self, shard: int) -> bool:
        """Drop ``shard`` from the quorum and swap the serving program to
        the surviving replicas' aggregate (``parallel/sharded.
        replica_subset_serving``; single-device, bitwise the subset
        aggregate recomputed offline). Returns whether this call newly
        degraded (False: the shard had already failed)."""
        from spark_bagging_tpu_torch.parallel.sharded import (
            replica_subset_serving,
        )

        with self._build_lock:
            if self._n_shards is None or shard in self._failed_shards:
                return False
            if not 0 <= shard < self._n_shards:
                raise ValueError(
                    f"shard must be in [0, {self._n_shards}), got {shard}"
                )
            n_rep = int(self.model.n_estimators_)
            per = n_rep // self._n_shards
            failed = self._failed_shards | {shard}
            survivors = [i for i in range(n_rep) if i // per not in failed]
            if not survivors:
                raise RuntimeError(
                    "every serving shard has failed; no surviving "
                    "replicas left to aggregate"
                )
            fn, rep_fn, params, subspaces = replica_subset_serving(
                self.model, survivors)
            self._failed_shards.add(shard)
            self._survivors = tuple(survivors)
            tag = ",".join(map(str, sorted(self._failed_shards)))
            self._swap_forward(
                fn, rep_fn, params, subspaces,
                f"|degraded-shards=[{tag}]")
        import warnings

        telemetry.inc("sbt_serving_shard_failures_total")
        telemetry.set_gauge("sbt_serving_degraded", 1.0)
        telemetry.set_gauge("sbt_serving_degraded_replicas",
                            float(len(survivors)))
        telemetry.emit_event({
            "kind": "serving_shard_failed",
            "shard": shard,
            "failed_shards": sorted(self._failed_shards),
            "survivors": len(survivors),
            "model": self.model_name,
            "version": self.model_version,
        })
        warnings.warn(
            f"serving shard {shard} dropped from the quorum; serving "
            f"the {len(survivors)}-replica surviving aggregate "
            "(degraded=true) until reset_degraded()",
            RuntimeWarning,
            stacklevel=3,
        )
        return True

    def _swap_forward(self, fn, rep_fn, params, subspaces,
                      tag: str) -> None:
        """Serve another forward from the next build on (the caller
        holds the build lock): every program of the old one is dropped,
        with the costs counted for it."""
        # sbt-lint: disable=shared-state-unlocked — every caller holds self._build_lock (_degrade_shard, reset_degraded)
        self._fn = fn
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
        self._replica_fn = rep_fn
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
        self._replica_unavailable = False
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
        self._params = params
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
        self._subspaces = subspaces
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
        self._variant = _pc.forward_variant(self.model) + tag
        # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
        self._replica_variant = (
            _pc.forward_variant(self.model, "replica") + tag)
        self._compiled.clear()
        self._replica_compiled.clear()
        self.bucket_costs.clear()
        self._counted.clear()
        # sbt-lint: disable=static-unlocked-check-then-act — under self._build_lock (above)
        if self._pool is not None:
            # the allocator refuses a capture into a private pool whose
            # last graph died, as the old forward's may have
            # sbt-lint: disable=shared-state-unlocked — under self._build_lock (above)
            self._pool = torch.cuda.graph_pool_handle()
        self._shard_pools.clear()

    def reset_degraded(self) -> bool:
        """Heal back to the full-quorum mesh program (the shard's device
        recovered, or a chaos run ended). Returns whether anything was
        reset."""
        from spark_bagging_tpu_torch.parallel.sharded import (
            replica_sharded_serving,
        )

        with self._build_lock:
            if not self._failed_shards:
                return False
            fn, rep_fn, params, subspaces, _dev, _n = \
                replica_sharded_serving(self.model, self.mesh)
            self._failed_shards.clear()
            self._survivors = None
            self._swap_forward(fn, rep_fn, params, subspaces, "")
        telemetry.set_gauge("sbt_serving_degraded", 0.0)
        telemetry.set_gauge("sbt_serving_degraded_replicas", 0.0)
        return True

    # -- model-quality tap ---------------------------------------------

    def attach_quality(self, monitor) -> None:
        """Install a quality monitor (see ``telemetry.quality.attach``,
        which also registers it for ``debug_summary``). The forward
        feeds it per packed batch; ``None`` detaches."""
        # sbt-lint: disable=shared-state-unlocked — single-reference last-write-wins swap; the hot path reads it exactly once per batch
        self._quality = monitor
        # a FRESH monitor deserves a fresh failure warning: without
        # the reset, monitor B dying after monitor A already warned
        # would detach silently and the model would serve unmonitored
        # with zero operator signal
        # sbt-lint: disable=shared-state-unlocked — same benign last-write-wins as the monitor reference above
        self._quality_warned = False

    def detach_quality(self) -> None:
        # sbt-lint: disable=shared-state-unlocked — see attach_quality
        self._quality = None

    @property
    def quality(self):
        """The attached quality monitor, or None."""
        return self._quality

    def warmup_replica(self, buckets=None) -> tuple[int, ...]:
        """Build the per-replica (disagreement-tap) program ahead of
        traffic — default: every bucket the SERVING forward already
        has. ``telemetry.quality.attach`` calls this when disagreement
        sampling is on (so sticky swap re-attaches do too): without it,
        the first sampled batch at each rung would absorb a capture
        stall on the live serving thread. A capture that fails raises
        here. Returns the buckets installed (built, or adopted from the
        program cache); empty when the model exposes no per-replica
        seam."""
        if buckets is None:
            buckets = self.compiled_buckets
        built = []
        for b in buckets:
            b = bucket_for(int(b), self.min_bucket_rows,
                           self.max_batch_rows)
            if b not in self._replica_compiled:
                if self._build_replica(b) is None:
                    break  # seam unavailable: nothing else will build
                built.append(b)
        return tuple(built)

    def _build_replica(self, bucket: int):
        """Install the per-replica (aggregation-free) program for one
        bucket — the disagreement tap's. Same double-checked build lock
        as :meth:`_build`; a program-cache hit adopts another
        executor's capture of the same model. Counts
        ``sbt_quality_disagreement_compiles_total``, never the serving
        counter. Returns None when the model exposes no per-replica
        seam."""
        if self._replica_unavailable:
            return None
        with self._build_lock:
            prog = self._replica_compiled.get(bucket)
            if prog is not None:
                return prog
            if self._replica_fn is None:
                try:
                    self._replica_fn, _, _ = self.model.replica_forward()
                except (AttributeError, NotImplementedError) as e:
                    # sbt-lint: disable=shared-state-unlocked — under self._build_lock
                    self._replica_unavailable = True
                    import warnings

                    warnings.warn(
                        "ensemble-disagreement tap disabled: the model "
                        f"exposes no replica_forward() ({e!r})",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    return None
            key = self._program_key(bucket, self._replica_variant)
            prog = _pc.cache().get(key)
            if prog is None:
                with telemetry.span("quality_replica_compile",
                                    bucket=bucket):
                    prog = self._new_program(bucket, self._replica_fn,
                                             row_axis=1)
                telemetry.inc("sbt_quality_disagreement_compiles_total")
                prog = _pc.cache().put(key, prog)
            # sbt-lint: disable=shared-state-unlocked — under self._build_lock
            self._replica_compiled[bucket] = prog
            self._export_pool_bytes()
            return prog

    def _replica_piece(self, Xp: np.ndarray, fill: int):
        """Per-replica output for one slab's real rows — ``(R, fill,
        C)`` / ``(R, fill)`` — or None when the seam is unavailable.
        ``Xp`` is the host slab the serving forward just ran."""
        bucket = Xp.shape[0]
        prog = self._replica_compiled.get(bucket)
        if prog is None:
            prog = self._build_replica(bucket)
            if prog is None:
                return None
        return prog.run(Xp, fill)

    def _feed_quality(self, mon, parts, outs, first_slab) -> None:
        """Deliver one packed batch to the attached monitor (sketches
        + sampled disagreement). Monitoring faults must never fail the
        serving it observes: first failure warns and detaches."""
        try:
            mon.observe_parts(parts, outs)
            if first_slab is not None and mon.wants_disagreement():
                rep = self._replica_piece(*first_slab)
                if rep is not None:
                    mon.observe_disagreement(rep, task=self.task)
        except Exception as e:  # noqa: BLE001 — the tap is optional
            # sbt-lint: disable=shared-state-unlocked — last-write-wins detach on failure; racing feeders at worst both detach
            self._quality = None
            if not self._quality_warned:
                # sbt-lint: disable=shared-state-unlocked — worst case under a race is a second warning, never a lost detach
                self._quality_warned = True
                import warnings

                warnings.warn(
                    f"quality monitor detached after a tap failure: "
                    f"{e!r}",
                    RuntimeWarning,
                    stacklevel=2,
                )

    # -- the forward ---------------------------------------------------

    def _validate(self, X) -> np.ndarray:
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            # single feature vector: the overwhelmingly common online
            # request shape — accept it as one row
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"X must be (n, {self.n_features}), got {X.shape}"
            )
        if X.shape[0] == 0:
            raise ValueError("X has no rows")
        return X

    def forward(self, X) -> np.ndarray:
        """Aggregated output for ``X`` — (n, C) probabilities for a
        classifier, (n,) predictions for a regressor. Rows run through
        the ragged pack plan (:func:`~spark_bagging_tpu_torch.serving.
        buckets.pack_plan`): full ladder rungs first, only the final
        slab padded, padding sliced off before anything is returned."""
        X = self._validate(X)
        (out,) = self._forward_packed([X])
        return out

    __call__ = forward

    def forward_parts(self, parts) -> list[np.ndarray]:
        """Ragged batch: serve several independent row blocks as ONE
        packed forward sequence and return one output per block.

        The blocks are packed back-to-back into the pack plan's slabs
        with a row-offset scatter; only the final slab carries padding.
        A block may span a slab boundary; bagging aggregation is
        row-local, so its rows' results do not depend on which slab (or
        which batch-mates) they rode with. This is the micro-batcher's
        scatter seam.
        """
        if not parts:
            return []
        return self._forward_packed([self._validate(p) for p in parts])

    def _forward_packed(self, parts: list[np.ndarray]) -> list[np.ndarray]:
        """Pack validated row blocks into plan slabs, run each slab,
        scatter outputs back per block."""
        sizes = [p.shape[0] for p in parts]
        n = sum(sizes)
        plan = pack_plan(n, self.min_bucket_rows, self.max_batch_rows)
        # gather: walk the blocks once, filling each slab in order;
        # only the last slab is partial (pack_plan's fill rule)
        slab_outs: list[np.ndarray] = []
        first_slab: tuple[np.ndarray, int] | None = None
        part_i = 0
        part_off = 0
        remaining = n
        for bucket in plan:
            fill = min(bucket, remaining)
            remaining -= fill
            part = parts[part_i]
            if fill == bucket and part.shape[0] - part_off >= fill:
                # the whole slab comes from one block: serve the slice
                # as-is (a view, no copy)
                Xp = part[part_off:part_off + fill]
                part_off += fill
                if part_off == part.shape[0]:
                    part_i += 1
                    part_off = 0
            else:
                # row-offset scatter: one zeroed slab buffer, each
                # block's rows copied in at its offset
                Xp = np.zeros((bucket, self.n_features), np.float32)
                off = 0
                while off < fill:
                    part = parts[part_i]
                    take = min(fill - off, part.shape[0] - part_off)
                    Xp[off:off + take] = part[part_off:part_off + take]
                    off += take
                    part_off += take
                    if part_off == part.shape[0]:
                        part_i += 1
                        part_off = 0
            if first_slab is None:
                # kept for the (sampled) disagreement tap: one slab per
                # packed batch is the tap's unit of work, replayed on
                # these host rows
                first_slab = (Xp, fill)
            while True:
                try:
                    slab_outs.append(self._forward_piece(Xp, fill))
                    break
                except faults.ShardFault as e:
                    # a mesh shard failed mid-forward: drop it from the
                    # quorum and serve this slab again through the
                    # survivors' aggregate. Each turn fails a new shard
                    # (bounded by the shard count); a fault naming a
                    # shard already failed is an ordinary error
                    if self.mesh is None or not self._degrade_shard(
                            e.shard):
                        raise
        # scatter back: slice each block's rows out of the slab outputs
        outs: list[np.ndarray] = []
        slab_i = 0
        slab_off = 0
        for size in sizes:
            pieces: list[np.ndarray] = []
            need = size
            while need:
                out = slab_outs[slab_i]
                take = min(need, out.shape[0] - slab_off)
                pieces.append(out[slab_off:slab_off + take])
                need -= take
                slab_off += take
                if slab_off == out.shape[0]:
                    slab_i += 1
                    slab_off = 0
            outs.append(pieces[0] if len(pieces) == 1
                        else np.concatenate(pieces))
        # model-quality tap: one attribute read when no monitor is
        # attached (the zero-overhead contract). This seam sits under
        # BOTH dispatch paths — the coalescing worker's forward_parts
        # and the direct-dispatch inline serve — and feeds real rows
        # only (padding never reaches the sketches). Outputs are
        # already finalized above: the tap cannot change what is served.
        mon = self._quality
        if mon is not None:
            self._feed_quality(mon, parts, outs, first_slab)
        # capacity demand tap: the same one-attribute-read contract as
        # the quality tap and faults.ACTIVE. Feeds per-model request/row
        # demand under BOTH dispatch paths; anonymous executors
        # (model_name unset — never registry-committed) stay out of the
        # demand table by design.
        cap = _capacity.ACTIVE
        if cap is not None and self.model_name is not None:
            cap.observe_demand(self.model_name, self.model_version,
                               len(parts), n)
        return outs

    # sbt-lint: hot-path
    def _forward_piece(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        """Run one bucket-shaped slab (``fill`` real rows, the rest
        padding) through its program; returns the real rows' output."""
        bucket = Xp.shape[0]
        if faults.ACTIVE is not None:
            # chaos probes (one module-attribute read when unarmed):
            # generic slab faults, and the mesh-forward seam that
            # stands for losing a shard's device mid-traffic
            faults.fire("executor.forward_piece", bucket=bucket)
            if self.mesh is not None and not self._failed_shards:
                faults.fire("executor.mesh_forward", bucket=bucket)
        degraded = bool(self._failed_shards)
        prog = self._compiled.get(bucket)
        if prog is None:
            prog = self._build(bucket)
        if telemetry.enabled():
            counts = [
                ("sbt_serving_rows_total", float(fill)),
                ("sbt_serving_padding_rows_total", float(bucket - fill)),
            ]
            if self.mesh is not None and not degraded:
                counts.append(("sbt_serving_shard_forwards_total", 1.0))
            if degraded:
                counts.append(("sbt_serving_degraded_forwards_total", 1.0))
            flops = self.bucket_costs.get(bucket, {}).get("flops")
            if flops:
                # rows are interchangeable within a bucket's program, so
                # padding's FLOP share is its row share — waste in
                # compute terms, not just rows
                counts.append(("sbt_serving_flops_total", flops))
                counts.append(("sbt_serving_padding_flops_total",
                               (bucket - fill) / bucket * flops))
            # one registry lock round-trip for the panel: this runs per
            # slab on the request hot path
            telemetry.inc_many(counts)
            telemetry.observe("sbt_serving_batch_fill_ratio",
                              fill / bucket)
        # attach the bucket choice to whatever request/batch trace is
        # current (multi-slab packs annotate once per slab)
        tracing.annotate(bucket=bucket)
        # performance-attribution probe (telemetry/perf.py): measured
        # per-bucket forward seconds joined with the build-time cost.
        # One module-attribute read when no plane is installed, no
        # clock, no call
        ap = _perf.ACTIVE
        t_perf = time.perf_counter() if ap is not None else 0.0
        if telemetry.sinks_active():
            with telemetry.span("serving_forward", bucket=bucket,
                                rows=fill):
                out = prog.run(Xp, fill)
        else:
            # nobody is listening for span events: skip the span
            # machinery
            out = prog.run(Xp, fill)
        if ap is not None:
            ap.observe_forward(bucket, fill, time.perf_counter() - t_perf,
                               self.bucket_costs.get(bucket))
        return out

    # -- sklearn-flavored conveniences ---------------------------------

    def predict_proba(self, X) -> np.ndarray:
        if self.task != "classification":
            raise AttributeError(
                "predict_proba is classification-only; this executor "
                f"serves a {self.task} model"
            )
        return self.forward(X)

    def predict(self, X) -> np.ndarray:
        out = self.forward(X)
        if self.task == "classification":
            return self.classes_[out.argmax(axis=1)]
        return out
