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

Not ported yet: mesh serving and the degraded-quorum surface (ROADMAP
Queue A 12), the quality tap, the capacity and performance planes
(Queue A 15). A CUDA graph cannot be serialized, so there is no
persisted executable cache: :meth:`restore_executables` ignores one.
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
from spark_bagging_tpu_torch.telemetry import tracing

_ROADMAP_MESH = "ROADMAP Queue A 12: parallel/"
_ROADMAP_PLANES = "ROADMAP Queue A 15: the host-side planes"

#: eager runs on a side stream before a capture (cuBLAS handles,
#: workspaces and the allocator's blocks settle outside the graph)
CAPTURE_WARMUP_ITERS = 2


class EagerProgram:
    """A CPU bucket program: the forward run eagerly at the bucket's
    shape. Reentrant (every call allocates its own output)."""

    nbytes = None

    def __init__(self, fn, params, subspaces, bucket: int, n_features: int):
        self._fn, self._params, self._subspaces = fn, params, subspaces
        # the build runs the forward once, as a capture's warm-up does
        fn(params, subspaces,
           torch.zeros((bucket, n_features), dtype=torch.float32))

    def run(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        X = (torch.from_numpy(Xp) if Xp.flags.writeable
             else torch.tensor(Xp))
        return self._fn(self._params, self._subspaces, X).numpy()[:fill]


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
    """

    def __init__(self, fn, params, subspaces, bucket: int, n_features: int,
                 pool, stream):
        device = subspaces.device
        self._fn, self._params, self._subspaces = fn, params, subspaces
        self.lock = threading.Lock()
        x = torch.zeros((bucket, n_features), dtype=torch.float32,
                        device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(CAPTURE_WARMUP_ITERS):
                warm = fn(params, subspaces, x)
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
        # never joins it)
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out.copy_(fn(params, subspaces, x))
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
            self.out_host[:fill].copy_(self.out[:fill], non_blocking=True)
            self.done.record()
            self.done.synchronize()
            return self._out_np[:fill].copy()


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
    ``mesh`` is mesh serving, not ported yet (raises).
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
        # the key's mesh component: None, or NotImplementedError for a mesh
        self.mesh_shape = _pc.mesh_shape(mesh)
        if min_bucket_rows < 1 or max_batch_rows < min_bucket_rows:
            raise ValueError(
                f"need 1 <= min_bucket_rows <= max_batch_rows, got "
                f"{min_bucket_rows}, {max_batch_rows}"
            )
        fn, params, subspaces = model.aggregated_forward()
        self.model = model
        self.task: str = model.task
        self.n_features: int = int(model.n_features_in_)
        self.classes_ = getattr(model, "classes_", None)
        self.min_bucket_rows = int(min_bucket_rows)
        self.max_batch_rows = int(max_batch_rows)
        self.device: torch.device = subspaces.device
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
        self._toolchain = _pc.toolchain_id(self.device)
        self._compiled: dict[int, Any] = {}
        self._build_lock = make_lock("serving.executor.build")
        # every bucket of this executor warms up and captures on one side
        # stream, into one graph pool: cuBLAS keeps a workspace for each
        # stream it runs on, so a stream a capture would cost one each
        self._pool = self._stream = None
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
        their builds (0 on the CPU)."""
        return sum(p.nbytes or 0 for p in list(self._compiled.values()))

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

    def _program_key(self, bucket: int) -> _pc.ProgramKey:
        return _pc.ProgramKey(
            self.fingerprint, self._variant, int(bucket), self.mesh_shape,
            *self._toolchain,
        )

    def _new_program(self, bucket: int):
        if self.device.type != "cuda":
            return EagerProgram(self._fn, self._params, self._subspaces,
                                bucket, self.n_features)
        try:
            return GraphProgram(self._fn, self._params, self._subspaces,
                                bucket, self.n_features, self._pool,
                                self._stream)
        except Exception as e:
            raise RuntimeError(
                f"CUDA-graph capture of the forward at bucket {bucket} "
                f"failed ({e!r}); a CUDA model is never served eagerly — "
                "the forward must not synchronize with the host or size "
                "its allocations from values it reads on the card"
            ) from e

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
            if prog is not None:
                self._compiled[bucket] = prog
                return prog
            t0 = time.perf_counter()
            with telemetry.span("serving_compile", bucket=bucket):
                prog = self._new_program(bucket)
            telemetry.inc("sbt_serving_compiles_total")
            if self.model_name is not None:
                # labeled twin: per-model build attribution
                telemetry.inc("sbt_serving_compiles_total",
                              labels={"model": str(self.model_name)})
            telemetry.observe("sbt_serving_compile_seconds",
                              time.perf_counter() - t0)
            prog = _pc.cache().put(key, prog)
            # sbt-lint: disable=shared-state-unlocked — under self._build_lock
            self._compiled[bucket] = prog
            if self.device.type == "cuda" and self.model_name is not None:
                telemetry.set_gauge("sbt_serving_graph_pool_bytes",
                                    float(self.graph_pool_bytes),
                                    labels={"model": str(self.model_name)})
            return prog

    def restore_executables(self, path: str) -> tuple[int, ...]:
        """Ignore a persisted executable cache (the JAX package's
        ``serving_aot/``): counted as one miss in
        ``sbt_serving_aot_misses_total``; the live buckets are captured
        at warm-up instead. Returns ``()``."""
        del path
        telemetry.inc("sbt_serving_aot_misses_total")
        return ()

    def release_programs(self) -> tuple[int, ...]:
        """Drop every bucket program: the in-instance ladder is cleared,
        so the captures (and their pool segments) free once no other
        executor holds them (the program cache keeps none alive). The
        executor stays serveable — the next request builds on demand.
        Returns the buckets released."""
        with self._build_lock:
            released = tuple(sorted(self._compiled))
            self._compiled.clear()
        if released:
            telemetry.inc("sbt_serving_programs_released_total",
                          float(len(released)))
        return released

    # -- surfaces not ported yet ---------------------------------------

    def degrade_shards(self, shards) -> None:
        raise NotImplementedError(f"degraded-quorum serving ({_ROADMAP_MESH})")

    def reset_degraded(self) -> bool:
        raise NotImplementedError(f"degraded-quorum serving ({_ROADMAP_MESH})")

    def attach_quality(self, monitor) -> None:
        raise NotImplementedError(f"the quality tap ({_ROADMAP_PLANES})")

    def warmup_replica(self, buckets=None) -> tuple[int, ...]:
        raise NotImplementedError(f"the quality tap ({_ROADMAP_PLANES})")

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
            slab_outs.append(self._forward_piece(Xp, fill))
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
        return outs

    # sbt-lint: hot-path
    def _forward_piece(self, Xp: np.ndarray, fill: int) -> np.ndarray:
        """Run one bucket-shaped slab (``fill`` real rows, the rest
        padding) through its program; returns the real rows' output."""
        bucket = Xp.shape[0]
        if faults.ACTIVE is not None:
            # chaos probe (one module-attribute read when unarmed)
            faults.fire("executor.forward_piece", bucket=bucket)
        prog = self._compiled.get(bucket)
        if prog is None:
            prog = self._build(bucket)
        if telemetry.enabled():
            # one registry lock round-trip for the panel: this runs per
            # slab on the request hot path
            telemetry.inc_many((
                ("sbt_serving_rows_total", float(fill)),
                ("sbt_serving_padding_rows_total", float(bucket - fill)),
            ))
            telemetry.observe("sbt_serving_batch_fill_ratio",
                              fill / bucket)
        # attach the bucket choice to whatever request/batch trace is
        # current (multi-slab packs annotate once per slab)
        tracing.annotate(bucket=bucket)
        if telemetry.sinks_active():
            with telemetry.span("serving_forward", bucket=bucket,
                                rows=fill):
                return prog.run(Xp, fill)
        # nobody is listening for span events: skip the span machinery
        return prog.run(Xp, fill)

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
