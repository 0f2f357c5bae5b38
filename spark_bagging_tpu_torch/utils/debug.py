"""Opt-in debug (sanitizer) mode.

The port of the JAX package's ``utils/debug.py``. Everything is OFF by
default, because every check costs a device sync or slows autograd.

torch has no counterpart of ``jax_debug_nans``, which re-runs any
compiled program that produced a NaN eagerly and raises at the first
NaN-producing operation. What the port checks instead, while debug is
active:

- **bootstrap weights**: every replica chunk's Poisson weights in
  ``fit_ensemble`` are read back to the host and must be finite and
  non-negative (:func:`check_bootstrap_weights`), as the JAX package
  checks each replica's draw; a negative or NaN weight means a broken
  draw or a reused buffer;
- **gradients**: ``torch.autograd.set_detect_anomaly(True)``, so the
  Adam-fitted learners (MLPs, FMs, the streamed fits) raise at the
  first backward operation that returns NaN, with the forward
  operation's traceback.

Usage::

    from spark_bagging_tpu_torch.utils.debug import debug_mode

    with debug_mode():
        clf.fit(X, y)

or process-wide: ``enable_debug()`` / ``disable_debug()``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

_active = False


def debug_active() -> bool:
    """Engine hook: are the debug checks enabled?"""
    return _active


def enable_debug() -> None:
    """Turn on anomaly detection and the engine checks process-wide."""
    global _active
    _active = True
    torch.autograd.set_detect_anomaly(True)


def disable_debug() -> None:
    global _active
    _active = False
    torch.autograd.set_detect_anomaly(False)


@contextlib.contextmanager
def debug_mode() -> Iterator[None]:
    """Scoped :func:`enable_debug`; restores the PRIOR state on exit,
    including an anomaly detection the user enabled directly through
    ``torch.autograd.set_detect_anomaly``."""
    global _active
    was_active = _active
    prior_anomaly = torch.is_anomaly_enabled()
    enable_debug()
    try:
        yield
    finally:
        _active = was_active
        torch.autograd.set_detect_anomaly(prior_anomaly)


def check_bootstrap_weights(w: torch.Tensor) -> None:
    """Sanitizer on a replica chunk's bootstrap weights ``(R, n)``
    (no-op unless debug is active): weights must be finite and
    non-negative. Reads the weights' extremes back to the host, a
    device sync, only in debug mode."""
    if not _active:
        return
    if w.dim() != 2:
        raise AssertionError(
            f"bootstrap weights must be (replicas, rows), got shape "
            f"{tuple(w.shape)}"
        )
    if not bool(torch.isfinite(w).all() and (w >= 0).all()):
        raise AssertionError(
            "bootstrap weights must be finite and >= 0 "
            f"(min={float(w.min())})"
        )
