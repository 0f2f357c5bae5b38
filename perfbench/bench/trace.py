"""The traced window: ``torch.profiler`` over the window's calls, read
back from its Chrome trace.

The trace's categories say what each event is: ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` ran on the device; ``user_annotation``
events are the host ranges (the harness's ``perfbench:*`` spans, the
program's telemetry spans, which become profiler ranges while a capture
is open, and ``bootstrap_weights``); ``cuda_runtime`` / ``cuda_driver``
events are the launches, tied to their kernels by ``correlation``.
Times are microseconds on the trace's one clock.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager

from bench import stats

WINDOW = "perfbench:window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Trace:
    """The events of one traced window."""

    def __init__(self, events: list[dict]):
        self.device: list[dict] = []
        self.ranges: list[dict] = []
        launch_ts: dict[int, float] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat == "user_annotation":
                self.ranges.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = e["ts"]
        self._launch_ts = launch_ts
        windows = [r for r in self.ranges if r["name"] == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"{len(windows)} '{WINDOW}' ranges in the trace")
        w = windows[0]
        self.lo, self.hi = w["ts"], w["ts"] + w["dur"]

    # -- the window ------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def _intervals(self, cats=DEVICE_CATS, match=None):
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.device
                if e["cat"] in cats and (match is None or match(e["name"]))]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        """Seconds of the window in which the device ran an operation of
        ``cats`` (the union of their intervals)."""
        return stats.union_length(self._intervals(cats), self.lo, self.hi) / 1e6

    def device_seconds(self, cats=DEVICE_CATS, names=None) -> float:
        """Summed device seconds of the window's operations of ``cats``
        whose name holds one of ``names`` (every name if None)."""
        def match(name):
            return names is None or any(k in name for k in names)
        return sum(min(e, self.hi) - max(s, self.lo)
                   for s, e in self._intervals(cats, match)
                   if e > self.lo and s < self.hi) / 1e6

    def seconds_under_range(self, range_name: str,
                            cats=DEVICE_CATS) -> float | None:
        """Device seconds of the operations launched while a host range
        named ``range_name`` was open (their launches' host times lie
        inside it). None if no such range ran in the window."""
        spans = [(r["ts"], r["ts"] + r["dur"]) for r in self.ranges
                 if r["name"] == range_name
                 and self.lo <= r["ts"] < self.hi]
        if not spans:
            return None
        spans = stats.merged(spans)
        total = 0.0
        for e in self.device:
            if e["cat"] not in cats:
                continue
            t = self._launch_ts.get((e.get("args") or {}).get("correlation"))
            if t is not None and any(s <= t < f for s, f in spans):
                total += e["dur"]
        return total / 1e6

    def range_seconds(self, name: str) -> list[float]:
        """Host seconds of each range named ``name`` in the window."""
        return [r["dur"] / 1e6 for r in self.ranges
                if r["name"] == name and self.lo <= r["ts"] < self.hi]

    # -- the breakdown ---------------------------------------------------

    def top_device_ops(self) -> list[list]:
        """The device operations that took most time, summed by name."""
        by = defaultdict(float)
        for e in self.device:
            if self.lo <= e["ts"] < self.hi:
                by[e["name"][:120]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]

    def host_path(self, t: float) -> str:
        """The nested host ranges open at trace time ``t``, outermost
        first, the window itself left out."""
        open_ = sorted((r for r in self.ranges
                        if r["ts"] <= t < r["ts"] + r["dur"]
                        and r["name"] != WINDOW),
                       key=lambda r: (r["ts"], -r["dur"]))
        return "/".join(r["name"] for r in open_) or "(no range)"

    def idle_gaps(self) -> list[list]:
        """The window's idle seconds, summed by what the host was in at
        each gap's middle, the largest first."""
        by = defaultdict(float)
        for s, e in stats.gaps(self._intervals(), self.lo, self.hi):
            by[self.host_path((s + e) / 2)[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]


@contextmanager
def profiled(out: dict):
    """Profile the block (host and CUDA activity); on exit
    ``out["trace"]`` holds its :class:`Trace`. The block opens the
    ``perfbench:window`` range itself around the calls it times."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    fd, path = tempfile.mkstemp(prefix="perfbench_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out["trace"] = Trace(events)
