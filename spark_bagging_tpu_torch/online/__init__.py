"""The continuous-learning plane: online updates of a fitted ensemble.

- :class:`~spark_bagging_tpu_torch.online.updater.OnlineUpdater` —
  streaming Poisson-weight ``partial_fit`` steps over the stacked
  replica axis (online bagging), with a streaming out-of-bag quality
  tap; its ``to_estimator()`` publishes through
  ``serving.ModelRegistry.swap``.

The JAX package's drift-triggered ``OnlineTrainer`` and its
``LabeledBuffer`` need the quality and alert planes, which are not
ported yet (ROADMAP Queue A 14).
"""

from spark_bagging_tpu_torch.online.updater import OnlineUpdater

__all__ = ["OnlineUpdater"]
