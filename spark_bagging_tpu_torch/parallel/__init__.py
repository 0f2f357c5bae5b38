"""Device-mesh parallelism, in one process or several: the port of the
JAX package's ``parallel/``.

- Replica-axis sharding: each shard of the ``replica`` mesh axis fits
  and forwards its slice of the ensemble;
- data-axis sharding: rows split over the ``data`` axis, the learners'
  row statistics summed over it. Every learner family runs on data and
  2-D meshes, and ``fit_stream`` takes the estimator's ``mesh=`` for
  both stream engines (streaming.py, tree_stream.py).

``shard_map`` (``compat.py``) runs one thread a mesh position and gives
the bodies JAX's collectives (``psum``, ``all_gather``, ``axis_index``)
in a fixed shard order. ``initialize_distributed`` (``distributed.py``)
joins several processes over gloo; a mesh made after the join spans
them, its collectives exchange through the host, and
``multihost.global_put`` / ``multihost.to_host`` are the estimator's
host/device seams on it.
"""

from spark_bagging_tpu_torch.parallel.compat import (
    HAS_SHARD_MAP,
    SHARD_MAP_SOURCE,
    ShardMapUnavailable,
    shard_map,
)
from spark_bagging_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    REPLICA_AXIS,
    device_put_rows,
    make_mesh,
)
from spark_bagging_tpu_torch.parallel.sharded import (
    sharded_fit,
    sharded_oob_scores,
    sharded_predict_classifier,
    sharded_predict_regressor,
)
from spark_bagging_tpu_torch.parallel.distributed import initialize_distributed

__all__ = [
    "HAS_SHARD_MAP",
    "SHARD_MAP_SOURCE",
    "ShardMapUnavailable",
    "shard_map",
    "DATA_AXIS",
    "REPLICA_AXIS",
    "device_put_rows",
    "make_mesh",
    "sharded_fit",
    "sharded_oob_scores",
    "sharded_predict_classifier",
    "sharded_predict_regressor",
    "initialize_distributed",
]
