"""Online inference serving: micro-batched, shape-bucketed, hot-swappable.

The training stack ends at batch ``predict``/``predict_proba`` — per
call, a request pays Python dispatch, a fresh host-to-device copy and
one launch per kernel of the ensemble forward. This package is the
request-level serving path on top of the fitted estimators, the port of
the JAX package's ``serving/``:

- :class:`EnsembleExecutor` (``executor.py``) — captures the aggregated
  ensemble forward once per power-of-two row bucket (``buckets.py``) as
  one CUDA graph over static buffers; steady-state traffic replays
  captured graphs only (**zero captures after warmup**, counted by
  ``sbt_serving_compiles_total``). A CPU model's bucket program is the
  eager forward at the bucket's shape, counted the same way.
- :class:`MicroBatcher` (``batcher.py``) — a bounded-queue background
  coalescer: concurrent ``submit()`` calls pack raggedly into the
  executor's slab plan within a ``max_delay_ms``/``max_batch_rows``
  window, with explicit :class:`Overloaded` backpressure, per-request
  deadlines (:class:`DeadlineExceeded`), bounded retry, bisect-on-poison
  and a supervised worker (:class:`Degraded` on a crash loop); when a
  streak of singleton batches proves there is nobody to coalesce with,
  **adaptive direct dispatch** serves lone requests inline on the
  caller's thread.
- :class:`ModelRegistry` (``registry.py``) — versioned registration and
  atomic hot-swap (``registry.swap(name, new_model)``), which captures
  the incoming model on the live bucket set before the switch, plus
  ``save``/``load`` of a checkpoint in the JAX package's format with a
  ``serve_config.json`` manifest.
- ``program_cache.py`` — the unified program cache: two executors of
  one model share one capture per bucket.

Everything is drillable deterministically through
``spark_bagging_tpu_torch.faults`` (the JAX package's fault sites).

Typical use::

    from spark_bagging_tpu_torch.serving import ModelRegistry

    registry = ModelRegistry()
    registry.register("clf", fitted_model, warmup=True)
    batcher = registry.batcher("clf", max_delay_ms=2.0)

    fut = batcher.submit(x_row)          # from any thread
    proba = fut.result()

    registry.swap("clf", retrained)      # atomic, mid-traffic
    batcher.close()
"""

from spark_bagging_tpu_torch.serving.batcher import (
    DeadlineExceeded,
    Degraded,
    MicroBatcher,
    Overloaded,
)
from spark_bagging_tpu_torch.serving.buckets import (
    bucket_for,
    bucket_ladder,
    next_pow2,
    pack_plan,
    pad_to_bucket,
)
from spark_bagging_tpu_torch.serving.executor import EnsembleExecutor
from spark_bagging_tpu_torch.serving.registry import ModelRegistry

__all__ = [
    "DeadlineExceeded",
    "Degraded",
    "EnsembleExecutor",
    "MicroBatcher",
    "ModelRegistry",
    "Overloaded",
    "bucket_for",
    "bucket_ladder",
    "next_pow2",
    "pack_plan",
    "pad_to_bucket",
]
