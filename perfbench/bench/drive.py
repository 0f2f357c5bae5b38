"""One run of one cell: set-up, the measured (or traced) window, the
check against the plain reference, and the result line.

What the window drives is the traffic mix's loop,
``perfbench/loops/<loop>.py``, found by the name the mix's file gives
(``bench/cell.py``). This module only sets up, times and judges:

- set-up (``setup_s``, from process start to the window) loads the port,
  makes the data from the seed on the device, and runs the loop's
  ``setup(run)``, which warms every shape the window uses;
- the window is a closed loop with one caller: ``call(run, i)``, timed
  here, back to back for ``--seconds``. A call that ends inside the
  window is whole and counts with its units; its record, if it returns
  one, is kept for the check. A traced run (``--trace 1``) profiles the
  loop's first ``TRACE_CALLS`` calls (or fewer, if ``--seconds`` ends
  first);
- after the window, the program's state freed, the loop's
  ``numbers(run, ref)`` compares what the window produced with the
  configuration's plain reference, each number against its limit;
- each metric of the cell, end-to-end (untraced) or per-layer (traced),
  is read by its reader ``perfbench/metrics/<metric>.py`` from the run.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

from bench import cell as cells
from bench import data, guard


class Spans:
    """The harness's own host spans around each call into a layer; in
    a traced window each is also a ``perfbench:<name>`` profiler range."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            from torch.profiler import record_function

            rf = record_function(f"perfbench:{name}")
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            self.items.append((name, t, time.perf_counter()))

    def totals(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s, e in self.items:
            out[name] = out.get(name, 0.0) + (e - s)
        return out


@dataclass
class Call:
    """One whole call of the window: host clock start and end, and the
    units it did (replicas fitted, rows predicted)."""
    start: float
    end: float
    units: float


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s entries laid over it, nested dicts merged."""
    if not over:
        return base
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def sample_pairs(seed: int, n_fits: int, n_replicas: int,
                 m: int) -> list[tuple[int, int]]:
    """``m`` (fit, replica) pairs of ``n_fits`` fits, drawn from the
    run's seed without replacement."""
    rng = np.random.default_rng([int(seed) % 2**63, 11])
    total = n_fits * n_replicas
    picks = rng.choice(total, size=min(m, total), replace=False)
    return sorted((int(p) // n_replicas, int(p) % n_replicas) for p in picks)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every one is finite
    and at most its limit."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        lim = float(limits[name])
        checks[name] = {"value": float(value), "limit": lim}
        ok = ok and math.isfinite(value) and value <= lim
    return ok, checks


def context(cfg: dict, seed: int, device: str, spans: Spans | None = None):
    """What a loop works with: the configuration, the seed, the device,
    the tables made from the seed (``X``, ``y``, ``Xp``; the whole set
    as ``tables``), a device ``sync()`` and the harness's spans. A loop
    keeps the system under test in ``state``, which the driver frees
    before the reference runs, and its kept outputs in ``records``."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    spans = spans or Spans()
    with spans("data"):
        tables = data.make(cfg["data"], seed, dev)
        sync()
    return SimpleNamespace(
        config=cfg, seed=seed, device=device, dev=dev, cuda=cuda,
        tables=tables, X=tables.X_fit, y=tables.y_fit, Xp=tables.X_pred,
        sync=sync, spans=spans, state=None, records=[])


def reference(run):
    """The configuration's plain reference over the run's tables."""
    return cells.module("reference", run.config["family"]).Reference(
        run.config, run.tables, run.dev)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(c: cells.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", sizes: dict | None = None,
        log=sys.stderr, starts: dict | None = None) -> dict:
    """One run of cell ``c``; returns the result line's object.
    ``sizes`` is laid over the configuration (the CPU tests' small
    sizes); ``starts`` are the seconds spent before this call, by part,
    for the set-up line."""
    import torch

    started = time.perf_counter() - t_start
    cfg = merge(c.config, sizes)
    loop = cells.loop(c.traffic["loop"], c.base)
    spans = Spans()
    with spans("import"):
        import spark_bagging_tpu_torch  # noqa: F401  the system under test
        from spark_bagging_tpu_torch.utils import native
    r = context(cfg, seed, device, spans)
    failures: list[str] = []
    loop.setup(r)
    setup_s = time.perf_counter() - t_start

    max_calls = loop.TRACE_CALLS if trace else math.inf
    calls: list[Call] = []
    attempted = 0

    def window(w0: float):
        nonlocal attempted
        deadline = w0 + seconds
        while len(calls) < max_calls and time.perf_counter() < deadline:
            t = time.perf_counter()
            with spans(loop.SPAN):
                try:
                    units, rec = loop.call(r, attempted)
                except Exception:  # noqa: BLE001 — a failed call is counted
                    failures.append(traceback.format_exc())
                    print(failures[-1], file=log)
                    units = rec = None
            t_end = time.perf_counter()
            if t_end > deadline and not trace:
                break  # not whole inside the window
            attempted += 1
            if units is None:
                continue
            calls.append(Call(t, t_end, float(units)))
            if rec is not None:
                r.records.append(rec)

    traced = {}
    if trace:
        from torch.profiler import record_function

        from bench import trace as tracing
        from spark_bagging_tpu_torch import telemetry

        spans.profiling = True
        with tracing.profiled(traced), telemetry.capture():
            with record_function(tracing.WINDOW):
                w0 = time.perf_counter()
                window(w0)
        spans.profiling = False
    else:
        w0 = time.perf_counter()
        window(w0)

    bad = guard.forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    peak = int(torch.cuda.max_memory_allocated(r.dev)) if r.cuda else 0

    # the check: the program's state freed first, then the reference
    r.state = None
    if r.cuda:
        torch.cuda.empty_cache()
    with spans("reference"):
        numbers = loop.numbers(r, reference(r))
        r.sync()
    ok, checks = judge(numbers, c.limits)
    ok = ok and not failures and bool(calls) and bool(numbers)

    # the end-to-end metrics, or the traced window's per-layer ones
    wanted = c.per_layer if trace else c.end_to_end
    view = SimpleNamespace(
        config=cfg, calls=calls, window_start=w0, setup_s=setup_s,
        trace=traced["trace"] if trace else None,
        counts=cells.module("counts", cfg["family"]))
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"], c.base)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev_info = {"platform": "gpu" if r.cuda else r.dev.type,
                "kind": torch.cuda.get_device_name(r.dev) if r.cuda
                else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(ok), "attempted": attempted,
              "failed": len(failures), "metrics": metrics,
              "device": dev_info}
    if trace:
        tr = traced["trace"]
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks

    # earlier lines of standard error: set-up, the window, the card
    tot = {**(starts or {"start": started}), **spans.totals()}
    parts = [f"{k} {v:.3f} s" for k, v in tot.items()
             if k not in (loop.SPAN, "reference")]
    print(f"setup: {', '.join(parts)}; setup_s {setup_s:.3f} s; kernel "
          f"build {native.build_info.get('seconds', 0.0):.3f} s", file=log)
    print(f"window: {len(calls)} whole calls of {attempted} attempted, "
          f"{len(failures)} failed; {len(r.records)} records kept; "
          f"reference check {tot.get('reference', 0.0):.3f} s", file=log)
    if calls:
        print(f"calls timed in the window: {len(calls)}", file=log)
    if r.cuda:
        print(f"card: {_power_limit()}", file=log)
    for name, ch in checks.items():
        verdict = "ok" if ch["value"] <= ch["limit"] else "FAIL"
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r} {verdict}",
              file=log)
    return result
