"""The profiler range that the ops open around their entry points."""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while a profiler session
    is on, else a shared no-op context. Opening a range costs about ten
    microseconds a call, which a small launch should not pay when no
    profiler is there to read it."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
