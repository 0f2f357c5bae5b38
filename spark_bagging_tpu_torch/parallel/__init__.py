"""Device-mesh parallelism in one process: the port of the JAX
package's ``parallel/``.

- Replica-axis sharding: each shard of the ``replica`` mesh axis fits
  and forwards its slice of the ensemble;
- data-axis sharding: rows split over the ``data`` axis, the learners'
  row statistics summed over it (logistic regression, ridge and the
  trees; the other families wait for ROADMAP Queue A 12 part 1b).

``shard_map`` (``compat.py``) runs one thread a mesh position and gives
the bodies JAX's collectives (``psum``, ``all_gather``, ``axis_index``)
in a fixed shard order. More than one process
(``initialize_distributed``) is ROADMAP Queue A 12 part 2.
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
]
