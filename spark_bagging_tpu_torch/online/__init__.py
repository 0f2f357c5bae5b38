"""The continuous-learning plane: online updates of a fitted ensemble.

This package only CONNECTS planes that exist elsewhere: ``ops/bootstrap``
draws bootstraps as weights, the quality plane (``telemetry/quality.py``,
``telemetry/alerts.py``) detects drift and fires alerts, the workload
recorder captures the serving request stream, and the registry
hot-swaps versions and writes ``serve_config.json``.

- :class:`~spark_bagging_tpu_torch.online.updater.OnlineUpdater` —
  streaming Poisson-weight ``partial_fit`` steps over the stacked
  replica axis (online bagging), with a streaming out-of-bag quality
  tap; its ``to_estimator()`` publishes through
  ``serving.ModelRegistry.swap``.
- :class:`~spark_bagging_tpu_torch.online.trainer.OnlineTrainer` — the
  drift-triggered trainer daemon: subscribes to the alert engine,
  drains recent labeled traffic, runs bounded update epochs, validates
  the candidate against the incumbent, and publishes through
  ``ModelRegistry.swap()``/``save()``.
- :class:`~spark_bagging_tpu_torch.online.trainer.LabeledBuffer` — the
  bounded labeled-traffic reservoir refits drain from.
"""

from spark_bagging_tpu_torch.online.trainer import LabeledBuffer, OnlineTrainer
from spark_bagging_tpu_torch.online.updater import OnlineUpdater

__all__ = ["LabeledBuffer", "OnlineTrainer", "OnlineUpdater"]
