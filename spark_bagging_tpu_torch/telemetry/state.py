"""Process-wide telemetry state: the enabled flags, THE registry, and
the active event sinks.

Kept in its own module so ``spans``/``sinks``/the package facade can
all import it without cycles. Host-side counters are ON by default
(cheap: one bool check + a locked float add on paths that already do
device dispatch); device-sync span timing is OPT-IN (the barrier
serializes the pipeline it measures). ``enabled = False`` turns every
telemetry call site into a single attribute read.
"""

from __future__ import annotations

import threading

from spark_bagging_tpu_torch.telemetry.registry import Registry


class TelemetryState:
    def __init__(self) -> None:
        self.enabled = True
        self.device_sync = False
        self.registry = Registry()
        self._sinks: list = []
        self._lock = threading.Lock()

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def emit(self, event: dict) -> None:
        """Deliver one event to every active sink (usually 0 or 1 —
        an open ``telemetry.capture()``). Cheap when no sink is open."""
        if not self._sinks:
            return
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            s.emit(event)


STATE = TelemetryState()
