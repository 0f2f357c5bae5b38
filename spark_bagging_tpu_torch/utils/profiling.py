"""Tracing and profiling hooks over ``torch.profiler``.

The port of the JAX package's ``utils/profiling.py``. Device traces are
``torch.profiler`` captures (a Chrome trace, viewable in Perfetto or
``chrome://tracing``); the engines' phases are ``torch.profiler``
ranges (``telemetry.phase``, ``ops/bootstrap.DRAW_RANGE``), so a trace
segments by ensemble phase.

Live profiling discipline: a process runs one capture at a time.
:func:`start_profile` / :func:`stop_profile` wrap ``torch.profiler`` in
a **single-flight guard** shared by every entry point (the
:func:`trace` context manager included), so a second concurrent capture
is rejected with :class:`ProfilerBusy` instead of stacking a second
profiler, and an optional ``max_seconds`` auto-stop (clamped to
:data:`PROFILE_MAX_SECONDS`) guarantees that a process asked for "a few
seconds of trace" is never left paying profiler overhead. Artifacts
default under ``telemetry_dir()/profiles/``.

:func:`device_peak_tflops` is the dense bf16 peak of the card the
``fit_report_``'s MFU is measured against.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Iterator

import torch

from spark_bagging_tpu_torch.analysis.locks import make_lock

log = logging.getLogger("spark_bagging_tpu_torch")


class ProfilerBusy(RuntimeError):
    """A device-profile capture is already running in this process: the
    second caller must wait or stop the live capture, not stack a new
    one."""


#: hard ceiling on any auto-stopped capture
PROFILE_MAX_SECONDS = 120.0

_profile_lock = make_lock("utils.profiling")
# guarded by _profile_lock; "timer" is the auto-stop handle, "prof" the
# live torch.profiler.profile
_profile: dict[str, Any] = {"active": False, "dir": None,
                            "t_start": None, "stops_at": None,
                            "timer": None, "seq": 0, "prof": None}


def default_profile_dir() -> str:
    """Where on-demand captures land: ``telemetry_dir()/profiles/``
    (``$SBT_TELEMETRY_DIR`` aware)."""
    from spark_bagging_tpu_torch.telemetry import telemetry_dir

    path = os.path.join(telemetry_dir(), "profiles")
    os.makedirs(path, exist_ok=True)
    return path


def profile_active() -> dict[str, Any] | None:
    """Snapshot of the live capture (dir, started, stops_at), or None."""
    with _profile_lock:
        if not _profile["active"]:
            return None
        return {
            "dir": _profile["dir"],
            "t_start": _profile["t_start"],
            "stops_at": _profile["stops_at"],
        }


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_profile(log_dir: str | None = None, *,
                  max_seconds: float | None = None) -> dict[str, Any]:
    """Start a device-trace capture (single-flight).

    ``log_dir`` defaults to a fresh timestamped directory under
    :func:`default_profile_dir`; the trace is written there as
    ``trace.json`` when the capture stops. ``max_seconds`` arms a daemon
    timer that auto-stops the capture (clamped to
    :data:`PROFILE_MAX_SECONDS`); ``None`` captures until
    :func:`stop_profile`.

    Raises :class:`ProfilerBusy` when a capture is already running
    (counted as ``sbt_profile_rejected_total``); never leaves the guard
    held on a failed profiler start.
    """
    from spark_bagging_tpu_torch import telemetry

    if max_seconds is not None:
        if max_seconds <= 0:
            raise ValueError(
                f"max_seconds must be > 0, got {max_seconds}"
            )
        max_seconds = min(float(max_seconds), PROFILE_MAX_SECONDS)
    with _profile_lock:
        if _profile["active"]:
            telemetry.inc("sbt_profile_rejected_total")
            raise ProfilerBusy(
                f"a profile capture is already running into "
                f"{_profile['dir']!r} (started "
                f"{time.time() - _profile['t_start']:.1f}s ago); stop "
                "it first: one capture per process"
            )
        _profile["seq"] += 1
        gen = _profile["seq"]
        if log_dir is None:
            log_dir = os.path.join(
                default_profile_dir(),
                f"profile_{int(time.time() * 1000)}_{gen}",
            )
        os.makedirs(log_dir, exist_ok=True)
        # a failed start leaves the guard released: state is only
        # updated after the profiler started
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        now = time.time()
        stops_at = (now + max_seconds if max_seconds is not None
                    else None)
        _profile.update(active=True, dir=log_dir, t_start=now,
                        stops_at=stops_at, prof=prof)
        if max_seconds is not None:
            # the timer carries its capture's generation: a stale
            # callback that lost the cancel race must not stop the
            # NEXT capture
            timer = threading.Timer(max_seconds, stop_profile,
                                    kwargs={"_gen": gen})
            timer.daemon = True
            _profile["timer"] = timer
            timer.start()
        telemetry.inc("sbt_profile_captures_total")
        telemetry.set_gauge("sbt_profile_active", 1.0)
    return {"dir": log_dir, "t_start": now, "stops_at": stops_at,
            "max_seconds": max_seconds}


def stop_profile(_gen: int | None = None) -> dict[str, Any] | None:
    """Stop the live capture, write its trace and return ``{"dir",
    "seconds"}``, or None when nothing is running (idempotent: the
    auto-stop timer and a manual stop may race; the loser is a no-op).
    ``_gen`` is the auto-stop timer's generation check."""
    from spark_bagging_tpu_torch import telemetry

    with _profile_lock:
        if not _profile["active"]:
            return None
        if _gen is not None and _gen != _profile["seq"]:
            return None  # stale auto-stop from a finished capture
        timer = _profile["timer"]
        if timer is not None:
            timer.cancel()
        out = {
            "dir": _profile["dir"],
            "seconds": time.time() - _profile["t_start"],
        }
        prof = _profile["prof"]
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(out["dir"], "trace.json"))
        finally:
            # the capture is over even when the export failed: a torn
            # artifact beats a wedged guard that rejects every capture
            _profile.update(active=False, dir=None, t_start=None,
                            stops_at=None, timer=None, prof=None)
            telemetry.set_gauge("sbt_profile_active", 0.0)
    return out


@contextlib.contextmanager
def trace(log_dir: str | None = None, *,
          max_seconds: float | None = None) -> Iterator[None]:
    """Capture a device trace for everything inside the block. Shares
    the single-flight guard: a concurrent or nested capture raises
    :class:`ProfilerBusy` up front."""
    start_profile(log_dir, max_seconds=max_seconds)
    try:
        yield
    finally:
        stop_profile()


@contextlib.contextmanager
def log_timing(label: str, level: int = logging.INFO) -> Iterator[None]:
    """Host-side wall-clock logging for coarse phases (ingestion, fit),
    also recorded as a ``telemetry.span`` with the log level as an
    attribute."""
    from spark_bagging_tpu_torch import telemetry

    t0 = time.perf_counter()
    try:
        with telemetry.span(label, log_level=logging.getLevelName(level)):
            yield
    finally:
        log.log(level, "%s: %.3fs", label, time.perf_counter() - t0)


# Published dense bf16 tensor-core peaks (TFLOP/s, no sparsity) of the
# H100 forms (NVIDIA H100 data sheet), matched against the name
# torch.cuda.get_device_name gives, most specific first: the SXM card
# reports "NVIDIA H100 80GB HBM3". MFU is reported against the bf16
# peak by convention, so fp32 solver passes show a correspondingly
# lower MFU.
_H100_PEAK_TFLOPS_BF16: tuple[tuple[str, float], ...] = (
    ("nvl", 835.5),
    ("pcie", 756.5),
    ("sxm", 989.4),
    ("hbm3", 989.4),
)


def device_peak_tflops(device=None) -> float | None:
    """The card's dense bf16 peak TFLOP/s, or None when unknown (the
    CPU, a card not in the table). ``device`` is a ``torch.device`` or
    its name; None means the current CUDA device where there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    if "h100" not in name:
        return None
    for sub, peak in _H100_PEAK_TFLOPS_BF16:
        if sub in name:
            return peak
    return None
